"""Class-API kernel tier of BlockDiagonalQR vs the XLA path (interpret mode).

The fused kernel tier (use_pallas) must be protocol-equivalent to the vmapped
XLA path: same factors where exposed, same least-squares solutions, same
health/rank semantics — including the lazily materialized dense surfaces.
Reference semantics: BlockDiagonalSparseQR.h:432-526.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qrkit_tpu.containers import BlockDiagonal
from qrkit_tpu.solvers import BlockDiagonalQR
from qrkit_tpu.solvers.block_diagonal import QFormat


def _mk(rng, nb=70, br=7, bc=2, tail_rows=0, tail_cols=0, dtype=None):
    blocks = jnp.asarray(rng.uniform(0.5, 5.0, size=(nb, br, bc)), dtype=dtype)
    return BlockDiagonal(blocks, nb * br + tail_rows, nb * bc + tail_cols)


def _pallas(**kw):
    qr = BlockDiagonalQR(QFormat.FULL_Q, pivot=False, use_pallas=True, **kw)
    qr._pallas_interpret = True
    return qr


@pytest.mark.parametrize("tail_cols", [0, 3])
def test_class_pallas_matches_xla(rng, tail_cols):
    mat = _mk(rng, tail_cols=tail_cols)
    qx = BlockDiagonalQR(QFormat.FULL_Q, pivot=False, use_pallas=False).compute(mat)
    qp = _pallas().compute(mat)
    assert qp._pallas_mode and not qx._pallas_mode
    assert str(qp.info()) == str(qx.info())
    np.testing.assert_allclose(
        np.asarray(qp.r_diagonal()), np.asarray(qx.r_diagonal()),
        rtol=1e-12, atol=1e-12,
    )
    b = rng.normal(size=mat.nrows)
    xs = np.asarray(qp.solve(jnp.asarray(b)))
    xr = np.asarray(qx.solve(jnp.asarray(b)))
    np.testing.assert_allclose(xs, xr, rtol=0, atol=1e-9)
    assert qp.rank == qx.rank
    # lazy dense surfaces: materialized on demand, identical factors
    np.testing.assert_allclose(
        np.asarray(qp.matrix_r_dense()), np.asarray(qx.matrix_r_dense()),
        rtol=1e-12, atol=1e-12,
    )
    m = rng.normal(size=(mat.nrows, 3))
    np.testing.assert_allclose(
        np.asarray(qp.apply_qt(jnp.asarray(m))),
        np.asarray(qx.apply_qt(jnp.asarray(m))),
        rtol=1e-12, atol=1e-12,
    )
    # matrix RHS rides the generic path through the same factors
    B = rng.normal(size=(mat.nrows, 2))
    np.testing.assert_allclose(
        np.asarray(qp.solve(jnp.asarray(B))),
        np.asarray(qx.solve(jnp.asarray(B))),
        rtol=0, atol=1e-9,
    )


def test_soa_container_roundtrip_and_solver(rng):
    nb, br, bc = 50, 2, 1
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    soa = jnp.asarray(blocks.transpose(1, 2, 0).reshape(br * bc, nb))
    m_soa = BlockDiagonal.from_soa(soa, br, bc)
    assert m_soa.is_soa and m_soa.shape == (nb * br, nb * bc)
    np.testing.assert_array_equal(np.asarray(m_soa.blocks), blocks)
    m_aos = BlockDiagonal(jnp.asarray(blocks), nb * br, nb * bc)
    np.testing.assert_array_equal(np.asarray(m_aos.soa()), np.asarray(soa))
    qp = _pallas().compute(m_soa)
    qx = BlockDiagonalQR(QFormat.FULL_Q, pivot=False, use_pallas=False).compute(m_aos)
    b = rng.normal(size=nb * br)
    np.testing.assert_allclose(
        np.asarray(qp.solve(jnp.asarray(b))),
        np.asarray(qx.solve(jnp.asarray(b))),
        rtol=0, atol=1e-10,
    )
    # dense surfaces rebuilt from the lane-major store
    np.testing.assert_allclose(
        np.asarray(qp.matrix_r_dense()), np.asarray(qx.matrix_r_dense()),
        rtol=1e-12, atol=1e-12,
    )


def test_auto_selects_xla_on_cpu(rng):
    """On the CPU backend "auto" keeps the XLA path."""
    mat = _mk(rng, nb=10)
    qr = BlockDiagonalQR(QFormat.FULL_Q, pivot=False)  # auto
    qr.compute(mat)
    assert qr._pallas_mode is False


@pytest.mark.parametrize(
    "backend,dtype,pivot,shape,want",
    [
        ("gpu", jnp.float32, False, (7, 2), True),
        ("gpu", jnp.float64, False, (7, 2), False),   # fp32 only
        ("gpu", jnp.float32, True, (7, 2), False),    # ColPiv stays on XLA
        ("gpu", jnp.float32, False, (2, 7), False),   # landscape
        ("gpu", jnp.float32, False, (16, 5), False),  # too many entries
        ("cpu", jnp.float32, False, (7, 2), False),
    ],
)
def test_auto_selection_rule(rng, monkeypatch, backend, dtype, pivot, shape, want):
    """"auto" picks the kernel only on a GPU backend, in fp32, for
    supported geometry; the decision is made per compute()."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    mat = _mk(rng, nb=10, br=shape[0], bc=shape[1], dtype=dtype)
    qr = BlockDiagonalQR(QFormat.FULL_Q, pivot=pivot)
    assert qr._pallas_active(mat) is want


def test_force_pallas_raises_on_unsupported(rng):
    mat = _mk(rng, nb=10)
    with pytest.raises(ValueError, match="use_pallas"):
        BlockDiagonalQR(pivot=True, use_pallas=True).compute(mat)
    with pytest.raises(ValueError, match="use_pallas"):
        BlockDiagonalQR(pivot=False, use_pallas=True).compute(
            _mk(rng, nb=10, br=2, bc=3)
        )


def test_pallas_dispatch_pins(rng):
    """Kernel-tier compute and vector solve are ONE program each."""
    from qrkit_tpu import count_dispatches

    mat = _mk(rng, nb=40)
    qp = _pallas()
    qp.compute(mat)  # warm
    mat2 = BlockDiagonal(mat.blocks * 1.000001, mat.nrows, mat.ncols)
    with count_dispatches() as d:
        qp.compute(mat2)
    assert d.count <= 1, f"kernel compute dispatched {d.count}"
    b = jnp.asarray(rng.normal(size=mat.nrows))
    qp.solve(b)
    with count_dispatches() as d:
        qp.solve(b)
    assert d.count <= 1, f"kernel solve dispatched {d.count}"
