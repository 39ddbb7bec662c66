"""Dispatch-count pins for the advertised O(1)-dispatch fused paths.

Each compiled-program execution is one kernel launch sequence plus host-side
dispatch overhead (tens of µs), which at the small and medium sizes these
paths serve is comparable to the device work itself, so "fused" is a
quantitative claim:
these tests count executions with qrkit_tpu.count_dispatches and fail if a
regression reintroduces eager glue.  Reference context: the reference pays
the analogous cost as per-block host loops (BandedBlockedSparseQR.h:442-519);
the whole point of the jit-fused rewrite is that a refactorize or solve is
ONE program.

Counts include every execution — eager ops, device_put uploads, the fused
program itself — so the pinned numbers are the true per-call launch budget.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from qrkit_tpu import count_dispatches
from qrkit_tpu.containers import BlockMatrix1x2
from qrkit_tpu.solvers import (
    BandedBlockedQR,
    BlockAngularQR,
    BlockedThinSparseQR,
    DenseColPivQR,
    DenseHouseholderQR,
    SegmentedBandedQR,
)
from qrkit_tpu.sparse import SparseCSR

from generators import (
    block_angular_matrix,
    overlapping_block_diagonal_matrix,
)


def _banded(kind):
    if kind == "banded":
        return BandedBlockedQR(suggested_block_cols=4)
    return SegmentedBandedQR(
        suggested_block_cols=4, segment_blocks=8, fallback=False
    )


@pytest.mark.parametrize("kind", ["banded", "segmented"])
def test_factorize_values_one_dispatch(rng, kind):
    """Device-resident refactorize = ONE program (health check included —
    the eager r_diagonal probe cost 20-40 extra dispatches before it was
    folded into the factorize program)."""
    mat = overlapping_block_diagonal_matrix(96, 336, rng, permute_rows=False)
    qr = _banded(kind).compute(mat)
    v = jnp.asarray(mat.data) * 1.000001
    qr.factorize_values(v)  # warm (compile + caches)
    with count_dispatches() as d:
        qr.factorize_values(v)
    assert d.count <= 1, f"refactorize dispatched {d.count} programs"
    assert str(qr.info()) == "ComputationInfo.SUCCESS"


@pytest.mark.parametrize("kind", ["banded", "segmented"])
@pytest.mark.parametrize("nrhs", [None, 3])
def test_solve_one_dispatch(rng, kind, nrhs):
    """Vector AND matrix-RHS least-squares solve = ONE fused program."""
    mat = overlapping_block_diagonal_matrix(96, 336, rng, permute_rows=False)
    qr = _banded(kind).compute(mat)
    shape = (mat.nrows,) if nrhs is None else (mat.nrows, nrhs)
    b = jnp.asarray(rng.normal(size=shape))
    x_warm = qr.solve(b)
    with count_dispatches() as d:
        x = qr.solve(b)
    assert d.count <= 1, f"solve dispatched {d.count} programs"
    assert np.abs(np.asarray(x) - np.asarray(x_warm)).max() == 0.0


@pytest.mark.parametrize("kind", ["banded", "segmented"])
def test_sparse_qproduct_recompute_one_dispatch(rng, kind):
    """Plan-cached sparse Q-product on a same-layout operand = ONE program."""
    mat = overlapping_block_diagonal_matrix(96, 336, rng, permute_rows=False)
    qr = _banded(kind).compute(mat)
    r_, c_, v_ = [], [], []
    for j in range(6):
        nzr = rng.choice(mat.nrows, size=5, replace=False)
        r_.extend(nzr)
        c_.extend([j] * 5)
        v_.extend(rng.normal(size=5))
    S = SparseCSR.from_triplets(r_, c_, v_, (mat.nrows, 6))
    qr.apply_qt_sparse(S)  # warm: plan + compile
    S2 = SparseCSR(S.shape, S.indptr, S.indices, S.data * 2.0)
    S2._fp_memo = S.pattern_fingerprint()
    with count_dispatches() as d:
        qr.apply_qt_sparse(S2)
    # one fused apply program; the output-value fetch is a copy, not a launch
    assert d.count <= 2, f"sparse Q-product dispatched {d.count} programs"


def test_thin_fused_compute_dispatch_budget(rng):
    """Same-layout thin-sparse compute: bounded launch budget (upload, fused
    height-bucketed factorize, WY seq assembly, fused triu+diag+health)."""
    tm = overlapping_block_diagonal_matrix(32, 112, rng, permute_rows=False)
    thin = BlockedThinSparseQR(suggested_block_cols=2)
    thin.compute(tm)
    tm2 = SparseCSR(tm.shape, tm.indptr, tm.indices, tm.data * 1.5)
    tm2._fp_memo = tm.pattern_fingerprint()
    with count_dispatches() as d:
        thin.compute(tm2)
    assert d.count <= 9, f"thin compute dispatched {d.count} programs"


def test_dense_compute_one_dispatch(rng):
    """Dense factorizations run as ONE program (QR + triu + health)."""
    a = jnp.asarray(rng.normal(size=(24, 8)))
    for qr in (DenseHouseholderQR(), DenseColPivQR()):
        qr.compute(a)  # warm
        with count_dispatches() as d:
            qr.compute(a)
        assert d.count <= 1, f"{type(qr).__name__} dispatched {d.count}"


def test_block_angular_recompute_dispatch_budget(rng):
    """Banded-left sparse-A2 recompute on a cached plan: the fused chunked
    solveRightBlock plus the inner solvers' fused programs — a small, pinned
    launch budget (was ~53 before the health probes were folded in)."""
    npar, nang = 96, 5
    am = block_angular_matrix(npar, nang, 7 * (npar // 2), rng)
    left_m = am.slice_cols(0, npar)
    dense_r = am.hstack_dense_block(npar, nang)
    right_sp = SparseCSR.from_dense(
        np.where(rng.random(dense_r.shape) < 0.4, dense_r, 0.0)
    )
    ba = BlockAngularQR(BandedBlockedQR(suggested_block_cols=4), DenseColPivQR())
    ba.compute(BlockMatrix1x2(left_m, right_sp))
    a2b = SparseCSR(
        right_sp.shape, right_sp.indptr, right_sp.indices, right_sp.data * 1.7
    )
    a2b._fp_memo = right_sp.pattern_fingerprint()
    with count_dispatches() as d:
        ba.compute(BlockMatrix1x2(left_m, a2b))
    assert d.count <= 6, f"block-angular recompute dispatched {d.count}"
    assert str(ba.info()) == "ComputationInfo.SUCCESS"


def test_counter_nests_and_restores(rng):
    """The counter itself: nesting stacks, the hook is removed on exit."""
    import jax._src.pjit as pj
    from jax._src.interpreters import pxla

    before_call = pxla.ExecuteReplicated.__call__
    before_fp = pj._get_fastpath_data
    x = jnp.arange(8.0)
    with count_dispatches() as outer:
        _ = x * 2
        with count_dispatches() as inner:
            _ = x + 1
        _ = x - 1
    assert inner.count == 1
    assert outer.count == 3
    assert pxla.ExecuteReplicated.__call__ is before_call
    assert pj._get_fastpath_data is before_fp


def test_block_angular_fused_dense_dispatch_budget(rng):
    """The flagship dense-A2 stack (BlockDiagonalQR FULL_Q non-pivot left +
    DenseColPivQR right): warm recompute runs the ONE fused program plus the
    composite health combine; a vector solve is exactly ONE program."""
    from qrkit_tpu.containers import BlockDiagonal
    from qrkit_tpu.solvers import BlockDiagonalQR
    from qrkit_tpu.solvers.block_diagonal import QFormat

    N, br, bc, m2 = 64, 2, 1, 5
    blocks = jnp.asarray(rng.normal(size=(N, br, bc)))
    a2 = jnp.asarray(rng.normal(size=(N * br, m2)))
    b = jnp.asarray(rng.normal(size=N * br))
    blk = BlockDiagonal(blocks, N * br, N * bc)
    qr = BlockAngularQR(BlockDiagonalQR(QFormat.FULL_Q, pivot=False), DenseColPivQR())
    qr.compute(BlockMatrix1x2(blk, a2))
    assert qr._fused_dense
    with count_dispatches() as d:
        qr.compute(BlockMatrix1x2(blk, a2))
    assert d.count <= 2, f"fused dense recompute dispatched {d.count}"
    qr.solve(b)
    with count_dispatches() as d:
        qr.solve(b)
    assert d.count <= 1, f"fused dense solve dispatched {d.count}"
