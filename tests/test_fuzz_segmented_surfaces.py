"""Randomized geometry fuzz over EVERY public surface of SegmentedBandedQR.

The segmented solver's two-segment window machinery is position-based and
gapped/tall-block geometry is where silent breakage lives (a round-3 phase-2
reformulation passed the uniform tests and broke exactly here — CLAUDE.md).
This sweep drives randomized gapped / tall-block / ragged-tail geometries
through all five surfaces the next rewrite will touch:

  apply_q, apply_qt (vector + matrix), matrix-RHS solve,
  apply_q_sparse / apply_qt_sparse, and factorize_values,

checked against the solver's own explicit dense Q (reflector semantics:
SparseBlockYTY.h:101-139, SparseQRUtils.h:44-89) and against the plain-chain
solver's least-squares solution (unique for full-rank input, so it is a
cross-solver oracle even though the two Qs differ by the split column
permutation).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from qrkit_tpu.solvers import BandedBlockedQR, ComputationInfo, SegmentedBandedQR
from qrkit_tpu.sparse import Permutation, SparseCSR


# Dedicated tall-block cases (idx >= 10) at segment_blocks=8, where the
# shared-window phase-2 apply runs over a long uniform segment run.
# (seed, bc, ov, row multiplier, nblocks, ragged).
TALL_CASES = {
    10: (2000, 4, 2, 5, 32, False),
    11: (2001, 6, 2, 5, 28, True),
    12: (2002, 4, 1, 6, 40, False),
    13: (2004, 6, 3, 5, 30, False),
}


def _random_geometry(idx: int):
    """Randomized banded geometry; the first cases force the config-3 regime
    (blocks much taller than the column step → gap rows in the chain)."""
    if idx in TALL_CASES:
        seed, bc, ov, mult, nb, ragged = TALL_CASES[idx]
        rng = np.random.default_rng(seed)
        return (bc - ov) * mult, bc, ov, nb, False, ragged, rng
    rng = np.random.default_rng(1000 + idx)
    # the non-delegate segmented solver requires overlap <= column step
    # (boundary groups must not straddle two segments), i.e. ov <= bc // 2
    if idx < 3:  # tall blocks: br ≫ step, the gapped regime
        bc = int(rng.integers(4, 7))
        ov = int(rng.integers(1, bc // 2 + 1))
        br = int((bc - ov) * rng.integers(5, 9))
        nb = int(rng.integers(9, 14))
    else:
        bc = int(rng.integers(2, 7))
        ov = int(rng.integers(1, bc // 2 + 1))
        br = int(rng.integers(bc + 1, 3 * bc + 2))
        nb = int(rng.integers(8, 16))
    permute = bool(idx % 3 == 2)
    ragged = bool(idx % 2 == 1)
    return br, bc, ov, nb, permute, ragged, rng


def _build(br, bc, ov, nb, permute, ragged, rng):
    step = bc - ov
    ncols = step * nb + ov
    rows, cols, vals = [], [], []
    nrows = 0
    for i in range(nb):
        bri = br
        if ragged and i == nb - 1:  # ragged tail block: fewer rows
            bri = int(rng.integers(bc, br + 1))
        for r in range(bri):
            for c in range(bc):
                col = i * step + c
                if col < ncols:
                    rows.append(nrows + r)
                    cols.append(col)
                    vals.append(rng.uniform(0.5, 5.0))
        nrows += bri
    m = SparseCSR.from_triplets(rows, cols, vals, (nrows, ncols))
    if permute:
        m = m.permute_rows(Permutation(rng.permutation(nrows)))
    return m


def _sparse_operand(rng, m, m2=5):
    r_, c_, v_ = [], [], []
    for j in range(m2 - 1):
        nzr = rng.choice(m, size=min(4, m), replace=False)
        r_.extend(nzr)
        c_.extend([j] * len(nzr))
        v_.extend(rng.normal(size=len(nzr)))
    spread = list(range(0, m, 5))
    r_.extend(spread)
    c_.extend([m2 - 1] * len(spread))
    v_.extend(rng.normal(size=len(spread)))
    return SparseCSR.from_triplets(r_, c_, v_, (m, m2))


CASE_IDS = list(range(10)) + sorted(TALL_CASES)


def _make_seg(bc, idx):
    return SegmentedBandedQR(
        suggested_block_cols=bc,
        segment_blocks=8 if idx in TALL_CASES else 3,
        fallback=False,
    )


@pytest.mark.parametrize("idx", CASE_IDS)
def test_fuzz_segmented_all_surfaces(idx):
    br, bc, ov, nb, permute, ragged, rng = _random_geometry(idx)
    mat = _build(br, bc, ov, nb, permute, ragged, rng)
    seg = _make_seg(bc, idx).compute(mat)
    assert seg.info() == ComputationInfo.SUCCESS
    dense = mat.to_dense()

    # own-Q oracle: the explicit dense Q of THIS factorization
    Q = np.asarray(seg.matrix_q_dense())
    m = mat.nrows
    assert np.allclose(Q.T @ Q, np.eye(m), atol=1e-8)

    # 1-2) dense applies, vector and matrix operands
    vec = rng.normal(size=m)
    mt = rng.normal(size=(m, 3))
    assert np.allclose(np.asarray(seg.apply_qt(jnp.asarray(vec))), Q.T @ vec, atol=1e-8)
    assert np.allclose(np.asarray(seg.apply_q(jnp.asarray(vec))), Q @ vec, atol=1e-8)
    assert np.allclose(np.asarray(seg.apply_qt(jnp.asarray(mt))), Q.T @ mt, atol=1e-8)
    assert np.allclose(np.asarray(seg.apply_q(jnp.asarray(mt))), Q @ mt, atol=1e-8)

    # 3) matrix-RHS solve vs the plain-chain solver (cross-solver oracle:
    # the LS solution of a full-rank system is unique)
    plain = BandedBlockedQR(suggested_block_cols=bc).compute(mat)
    X_true = rng.normal(size=(mat.ncols, 3))
    B = dense @ X_true
    Xs = np.asarray(seg.solve(jnp.asarray(seg.rows_permutation().apply(B))))
    Xp = np.asarray(plain.solve(jnp.asarray(plain.rows_permutation().apply(B))))
    assert np.allclose(Xs, X_true, atol=1e-6), np.abs(Xs - X_true).max()
    assert np.allclose(Xs, Xp, atol=1e-6)

    # 4) sparse-operand Q products: dense agreement AND exact nnz parity
    S = _sparse_operand(rng, m)
    for fn, ref in ((seg.apply_qt_sparse, Q.T), (seg.apply_q_sparse, Q)):
        out = fn(S)
        refd = ref @ S.to_dense()
        assert np.abs(out.to_dense() - refd).max() < 1e-8
        assert out.nnz == int((np.abs(refd) > 0).sum())

    # 5) factorize_values: device-resident refactorize == fresh compute
    scale = 1.0 + rng.uniform(0.1, 0.5)
    seg.factorize_values(jnp.asarray(mat.data) * scale)
    assert seg.info() == ComputationInfo.SUCCESS
    mat2 = SparseCSR(mat.shape, mat.indptr, mat.indices, mat.data * scale)
    seg2 = _make_seg(bc, idx).compute(mat2)
    d_refac = np.asarray(seg.r_diagonal())
    d_fresh = np.asarray(seg2.r_diagonal())
    np.testing.assert_allclose(d_refac, d_fresh, rtol=1e-12, atol=1e-12)
    b2 = mat2.to_dense() @ X_true[:, 0]
    x_refac = np.asarray(seg.solve(jnp.asarray(seg.rows_permutation().apply(b2))))
    assert np.allclose(x_refac, X_true[:, 0], atol=1e-6)


def test_fuzz_covers_gapped_geometry():
    """The sweep must actually hit gap rows (num_zeros > 0 in the chain
    geometry) — the regime the round-3 revert proved dangerous."""
    from qrkit_tpu.solvers.banded_blocked import banded_geometry

    saw_gap = 0
    for idx in CASE_IDS:
        br, bc, ov, nb, permute, ragged, rng = _random_geometry(idx)
        mat = _build(br, bc, ov, nb, permute, ragged, rng)
        qr = BandedBlockedQR(suggested_block_cols=bc)
        qr.analyze_pattern(mat)
        g = banded_geometry(qr.plan)
        if int(np.max(g["num_zeros"])) > 0:
            saw_gap += 1
    assert saw_gap >= 3, f"only {saw_gap} gapped cases in the sweep"
