"""Segmented banded QR vs. the plain banded solver (same contract)."""
import jax.numpy as jnp
import numpy as np
import pytest

from qrkit_tpu.solvers import BandedBlockedQR, SegmentedBandedQR

from generators import overlapping_block_diagonal_matrix

NUM_VARS = 96
NUM_PARAMS = NUM_VARS * 2
NUM_RESIDUALS = NUM_VARS * 7


def test_segmented_matches_contract(rng):
    spj = overlapping_block_diagonal_matrix(NUM_PARAMS, NUM_RESIDUALS, rng, False)
    qr = SegmentedBandedQR(suggested_block_cols=2, segment_blocks=8).compute(spj)
    dense = spj.to_dense()
    pA = qr.rows_permutation().apply(dense)
    pAP = pA[:, qr.cols_permutation().indices]
    # Qt (P_r A P_c) == R
    R = np.asarray(qr.matrix_r_dense())
    QtAP = np.asarray(qr.apply_qt(jnp.asarray(pAP)))
    assert np.allclose(QtAP, R, atol=1e-8), np.abs(QtAP - R).max()
    assert np.allclose(np.tril(R, -1), 0.0, atol=1e-10)
    # orthogonality
    v = rng.normal(size=spj.nrows)
    vv = np.asarray(qr.apply_q(qr.apply_qt(jnp.asarray(v))))
    assert np.allclose(vv, v, atol=1e-9)
    # LS round trip
    x_true = rng.normal(size=spj.ncols)
    b = qr.rows_permutation().apply(dense @ x_true)
    x = np.asarray(qr.solve(jnp.asarray(b)))
    assert np.allclose(x, x_true, atol=1e-7), np.abs(x - x_true).max()


def test_segmented_matches_plain_solution(rng):
    spj = overlapping_block_diagonal_matrix(NUM_PARAMS, NUM_RESIDUALS, rng, False)
    dense = spj.to_dense()
    x_true = rng.normal(size=spj.ncols)
    b = dense @ x_true
    seg = SegmentedBandedQR(suggested_block_cols=2, segment_blocks=16).compute(spj)
    plain = BandedBlockedQR(suggested_block_cols=2).compute(spj)
    xs = np.asarray(seg.solve(jnp.asarray(seg.rows_permutation().apply(b))))
    xp = np.asarray(plain.solve(jnp.asarray(plain.rows_permutation().apply(b))))
    assert np.allclose(xs, xp, atol=1e-9)


def test_segmented_rejects_short_chain(rng):
    # with fallback disabled, a too-short chain still raises
    spj = overlapping_block_diagonal_matrix(16, 56, rng, False)
    with pytest.raises(ValueError):
        SegmentedBandedQR(
            suggested_block_cols=2, segment_blocks=32, fallback=False
        ).compute(spj)


def test_fallback_to_banded(rng):
    """Non-segmentable plans delegate to BandedBlockedQR (docstring contract)."""
    from generators import overlapping_block_diagonal_matrix
    from qrkit_tpu.solvers import SegmentedBandedQR
    from qrkit_tpu.solvers.base import ComputationInfo

    # chain of 16 blocks < 2*L=64: too short for segmentation
    spj = overlapping_block_diagonal_matrix(32, 112, rng, permute_rows=False)
    qr = SegmentedBandedQR(suggested_block_cols=2, segment_blocks=32).compute(spj)
    assert qr._delegate is not None
    assert qr.info() == ComputationInfo.SUCCESS
    dense = spj.to_dense()
    x_true = rng.normal(size=spj.ncols)
    b = qr.rows_permutation().apply(dense @ x_true)
    x = np.asarray(qr.solve(jnp.asarray(b)))
    assert np.allclose(x, x_true, atol=1e-8)
    # fallback=False keeps the old raising behavior
    import pytest as _pytest

    with _pytest.raises(ValueError, match="BandedBlockedQR"):
        SegmentedBandedQR(
            suggested_block_cols=2, segment_blocks=32, fallback=False
        ).compute(spj)


def test_segmented_grouped_chain_matches_contract(rng):
    """Long chains re-block the boundary chain into groups (G > 1): the
    grouped plan must preserve the full solver contract (R, Q applies,
    diagonal, sparse export, LS solve)."""
    spj = overlapping_block_diagonal_matrix(256, 896, rng, False)
    qr = SegmentedBandedQR(suggested_block_cols=2, segment_blocks=4).compute(spj)
    assert qr._delegate is None
    assert qr._chain_group > 1  # the re-blocking actually engaged
    dense = spj.to_dense()
    pA = qr.rows_permutation().apply(dense)
    pAP = pA[:, qr.cols_permutation().indices]
    R = np.asarray(qr.matrix_r_dense())
    QtAP = np.asarray(qr.apply_qt(jnp.asarray(pAP)))
    assert np.allclose(QtAP, R, atol=1e-8), np.abs(QtAP - R).max()
    assert np.allclose(np.tril(R, -1), 0.0, atol=1e-10)
    # r_diagonal and the sparse export agree with the dense R
    assert np.allclose(np.asarray(qr.r_diagonal()), np.diag(R)[: spj.ncols], atol=1e-10)
    Rs = qr.matrix_r_sparse().to_dense()
    assert np.allclose(Rs, R[: Rs.shape[0]], atol=1e-10)
    v = rng.normal(size=spj.nrows)
    vv = np.asarray(qr.apply_q(qr.apply_qt(jnp.asarray(v))))
    assert np.allclose(vv, v, atol=1e-9)
    x_true = rng.normal(size=spj.ncols)
    b = qr.rows_permutation().apply(dense @ x_true)
    x = np.asarray(qr.solve(jnp.asarray(b)))
    assert np.allclose(x, x_true, atol=1e-7), np.abs(x - x_true).max()


def _bench_shape_banded(nb, rng, br=21, bc=10, ov=4):
    """Row-sorted banded layout in the README benchmark's shape (21x10
    blocks overlapping 4 cols) — the layout whose stored entries are one
    contiguous run per interior panel."""
    from qrkit_tpu.sparse import SparseCSR

    step = bc - ov
    ncols = step * nb + ov
    i = np.arange(nb)[:, None, None]
    r = np.arange(br)[None, :, None]
    c = np.arange(bc)[None, None, :]
    rows = np.broadcast_to(i * br + r, (nb, br, bc)).ravel()
    cols = np.broadcast_to(i * step + c, (nb, br, bc)).ravel()
    keep = cols < ncols
    vals = rng.uniform(0.5, 5.0, size=rows.size)
    return SparseCSR.from_triplets(
        rows[keep], cols[keep], vals[keep], (br * nb, ncols)
    )


def test_gather_free_extraction_fast_paths(rng):
    """Row-sorted banded layouts must take the gather-free panel/slab
    extraction (reshape + mask + static slice; seam-window slab cut) — a
    silent fallback to the element gather is a ~50x regression of the
    factorize's extraction stage.  The 7x2 fixture's layout is NOT
    run-contiguous per panel and must keep the gather fallback; both must
    produce correct factors."""
    mat = _bench_shape_banded(160, rng)
    qr = SegmentedBandedQR(suggested_block_cols=10, segment_blocks=32).compute(mat)
    assert qr._delegate is None
    assert qr._panel_fast is not None  # d0-shifted contiguous-run form
    assert qr._panel_fast["d0"] > 0
    assert qr._slab_fast is not None  # seam-window slab cut
    x_true = rng.normal(size=mat.ncols)
    b = qr.rows_permutation().apply(mat.to_dense() @ x_true)
    x = np.asarray(qr.solve(jnp.asarray(b)))
    assert np.allclose(x, x_true, atol=1e-7), np.abs(x - x_true).max()

    # gather fallback still taken and correct on a non-run-contiguous layout
    spj = overlapping_block_diagonal_matrix(192, 672, rng, False)
    qr2 = SegmentedBandedQR(suggested_block_cols=2, segment_blocks=8).compute(spj)
    assert qr2._delegate is None
    assert qr2._panel_fast is None
    x_true = rng.normal(size=spj.ncols)
    b = qr2.rows_permutation().apply(spj.to_dense() @ x_true)
    x = np.asarray(qr2.solve(jnp.asarray(b)))
    assert np.allclose(x, x_true, atol=1e-7), np.abs(x - x_true).max()


def test_tall_block_config3_geometry(rng):
    """BASELINE config-3 geometry in miniature (40x8 blocks, 4-col step —
    blocks 5x taller than the column step, so most of every block lands in
    the boundary composition): full solver contract on the shape whose
    production-size plan has nbot ~3.6x the rows of the 21x10 chain."""
    mat = _bench_shape_banded(160, rng, br=40, bc=8, ov=4)
    qr = SegmentedBandedQR(suggested_block_cols=8, segment_blocks=32).compute(mat)
    assert qr._delegate is None
    assert qr._panel_fast is not None  # run-contiguous layout: fast extraction
    dense = mat.to_dense()
    pA = qr.rows_permutation().apply(dense)
    pAP = pA[:, qr.cols_permutation().indices]
    R = np.asarray(qr.matrix_r_dense())
    QtAP = np.asarray(qr.apply_qt(jnp.asarray(pAP)))
    assert np.allclose(QtAP, R, atol=1e-8), np.abs(QtAP - R).max()
    assert np.allclose(np.tril(R, -1), 0.0, atol=1e-10)
    v = rng.normal(size=mat.nrows)
    vv = np.asarray(qr.apply_q(qr.apply_qt(jnp.asarray(v))))
    assert np.allclose(vv, v, atol=1e-9)
    x_true = rng.normal(size=mat.ncols)
    b = qr.rows_permutation().apply(dense @ x_true)
    x = np.asarray(qr.solve(jnp.asarray(b)))
    assert np.allclose(x, x_true, atol=1e-7), np.abs(x - x_true).max()


def test_shared_backsub_gate_and_equality(rng):
    """The uniform fixture must take the shared-scalar interior
    back-substitution (the vmapped per-segment chunk + batched 10x10
    triangular_solve is the slow form at 20k blocks), and the two paths
    must agree to fp roundoff."""
    spj = overlapping_block_diagonal_matrix(NUM_PARAMS, NUM_RESIDUALS, rng, False)
    qr = SegmentedBandedQR(suggested_block_cols=2, segment_blocks=8).compute(spj)
    assert qr._delegate is None
    assert qr._bs_uniform and qr._bs_nuni >= 2
    x_true = rng.normal(size=spj.ncols)
    b = jnp.asarray(qr.rows_permutation().apply(spj.to_dense() @ x_true))
    x_shared = np.asarray(qr.solve(b))
    np.testing.assert_allclose(x_shared, x_true, atol=1e-7)
    # force the general path and compare (solve fn is cached per instance)
    qr._bs_uniform = False
    qr._solve_fn = None
    x_general = np.asarray(qr.solve(b))
    np.testing.assert_allclose(x_shared, x_general, atol=1e-10)


def test_stream_gap_mode_equality(rng):
    """The two-region ('gap') streaming phase-2 apply must bit-match the
    unrolled-static whole-buffer form on randomized gapped geometries
    (tall blocks: block rows >> column step, the config-3 regime where the
    mono window grows O(L * block_rows) wide)."""
    from qrkit_tpu.solvers.segmented_apply import (
        _p2_stream_plan,
        _segment_apply_cols_stream,
        _segment_apply_cols_shared_static,
    )

    saw_gap = False
    for trial in range(4):
        if trial < 2:  # config-3-like: tall blocks, long chain — must be gap
            br, step, L = int(rng.integers(30, 48)), 4, 16
        else:
            br = int(rng.integers(12, 48))   # block rows
            step = int(rng.integers(2, 7))   # column advance per step
            L = int(rng.integers(6, 20))
        o = step                             # emitted rows per step
        sp = 2 * o                           # carry depth
        A = sp + br
        S, k = 5, 3
        s1t = tuple(max(0, o * (l - 1)) for l in range(L))
        s2t = tuple(br * l for l in range(L))
        spt = (0,) + (sp,) * (L - 1)
        R = br * L + sp
        plan = _p2_stream_plan(s1t, s2t, spt, A, L, R)
        assert plan is not None
        if trial < 2:
            assert plan["mode"] == "gap", (br, step, L, plan)
        saw_gap = saw_gap or plan["mode"] == "gap"  # noqa: F841 (documents intent)
        Yws = jnp.asarray(rng.normal(size=(S, L, A, o)))
        Ts = jnp.asarray(rng.normal(size=(S, L, o, o)))
        vt = jnp.asarray(rng.normal(size=(S, k, R)))
        out_s = np.asarray(
            _segment_apply_cols_stream(Yws, Ts, s1t, s2t, spt, vt, True)
        )
        out_u = np.asarray(
            _segment_apply_cols_shared_static(
                Yws, Ts, s1t, s2t, spt, vt, sp, True
            )
        )
        np.testing.assert_allclose(out_s, out_u, rtol=0, atol=1e-12)


def test_segment_space_solve_fast_path_equality(rng):
    """The segment-space fused solve (seg_contig + col_runs fast paths: pad+
    reshape input, batched-slice bottom windows, per-segment rhs — no global
    scatter/reorder) must match the general indexed path bit-for-bit on the
    same factors, for vector and matrix RHS."""
    mat = _bench_shape_banded(160, rng, br=40, bc=8, ov=4)
    qr = SegmentedBandedQR(suggested_block_cols=8, segment_blocks=32).compute(mat)
    assert qr._delegate is None
    b = jnp.asarray(rng.normal(size=mat.nrows))
    B = jnp.asarray(rng.normal(size=(mat.nrows, 3)))
    x_fast = np.asarray(qr.solve(b))
    xm_fast = np.asarray(qr.solve(B))
    assert qr._seg_contig and qr._col_runs  # the fast paths actually engaged
    qr._seg_contig = qr._col_runs = False
    qr._solve_fn = qr._solve_mat_fn = None
    x_gen = np.asarray(qr.solve(b))
    xm_gen = np.asarray(qr.solve(B))
    np.testing.assert_allclose(x_fast, x_gen, rtol=0, atol=1e-12)
    np.testing.assert_allclose(xm_fast, xm_gen, rtol=0, atol=1e-12)
