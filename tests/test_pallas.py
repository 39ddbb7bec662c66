"""Fused tiny-block Triton kernel vs the XLA path and NumPy fp64 (interpret
mode on the CPU; the compiled kernel runs on the card through chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest

from qrkit_tpu.functional import block_diagonal_lstsq
from qrkit_tpu.ops.pallas_blockdiag import (
    _LANES,
    block_lstsq,
    block_lstsq_jnp,
    block_rdiag,
    block_rdiag_jnp,
)

SHAPES = [(7, 2), (3, 1), (5, 3), (2, 1)]


def _system(rng, nb, br, bc):
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    x_true = rng.normal(size=(nb, bc))
    b = np.einsum("bij,bj->bi", blocks, x_true).reshape(-1)
    return blocks, x_true, b


def _lstsq_f64(blocks, b):
    nb, br, _ = blocks.shape
    bb = b.reshape(nb, br)
    return np.stack(
        [np.linalg.lstsq(blocks[i], bb[i], rcond=None)[0] for i in range(nb)]
    )


@pytest.mark.parametrize("nb,br,bc", [(700, 7, 2), (64, 3, 1), (1024, 5, 3), (700, 2, 1)])
def test_pallas_lstsq_matches_xla(rng, nb, br, bc):
    blocks, x_true, b = _system(rng, nb, br, bc)
    xp = np.asarray(
        block_lstsq(jnp.asarray(blocks), jnp.asarray(b), br, interpret=True)
    ).reshape(nb, bc)
    xx = np.asarray(
        block_diagonal_lstsq(jnp.asarray(blocks), jnp.asarray(b), pivot=False)
    ).reshape(nb, bc)
    np.testing.assert_allclose(xp, x_true, atol=1e-10)
    np.testing.assert_allclose(xp, xx, atol=1e-10)
    # inconsistent rhs: the least-squares solution, not an exact one
    noisy = b + rng.normal(size=b.shape)
    xn = np.asarray(
        block_lstsq(jnp.asarray(blocks), jnp.asarray(noisy), br, interpret=True)
    ).reshape(nb, bc)
    np.testing.assert_allclose(xn, _lstsq_f64(blocks, noisy), atol=1e-10)


@pytest.mark.parametrize("br,bc", SHAPES)
def test_pallas_qr_r(rng, br, bc):
    nb = 300
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    d = np.asarray(block_rdiag(jnp.asarray(blocks), br, interpret=True))
    dref = np.stack([np.diag(np.linalg.qr(blocks[i], mode="r")) for i in range(nb)])
    # R unique up to row signs
    np.testing.assert_allclose(np.abs(d.reshape(nb, bc)), np.abs(dref), atol=1e-10)
    dj = np.asarray(block_rdiag_jnp(jnp.asarray(blocks), br))
    np.testing.assert_array_equal(d.reshape(nb, bc), dj)


@pytest.mark.parametrize("nb", [1, _LANES - 1, _LANES + 1, 3 * _LANES + 17])
def test_pallas_nonmultiple_tile(rng, nb):
    """Batches that are not a multiple of the program size: the masked tail
    lanes load identity blocks, store nothing, and leave real lanes exact."""
    br, bc = 7, 2
    blocks, x_true, b = _system(rng, nb, br, bc)
    xp = np.asarray(
        block_lstsq(jnp.asarray(blocks), jnp.asarray(b), br, interpret=True)
    )
    assert xp.shape == (nb * bc,)
    np.testing.assert_allclose(xp.reshape(nb, bc), x_true, atol=1e-10)


@pytest.mark.parametrize("br,bc", SHAPES)
def test_pallas_soa_entry_points(rng, br, bc):
    """Lane-major ``[br*bc, nb]`` storage reads through the same kernel and
    gives bit-identical results to the AoS layout."""
    nb = 300
    blocks, _, b = _system(rng, nb, br, bc)
    soa = jnp.asarray(blocks.transpose(1, 2, 0).reshape(br * bc, nb))
    xa = np.asarray(block_lstsq(jnp.asarray(blocks), jnp.asarray(b), br, interpret=True))
    xs = np.asarray(block_lstsq(soa, jnp.asarray(b), br, soa=True, interpret=True))
    np.testing.assert_array_equal(xa, xs)
    da = np.asarray(block_rdiag(jnp.asarray(blocks), br, interpret=True))
    ds = np.asarray(block_rdiag(soa, br, soa=True, interpret=True))
    np.testing.assert_array_equal(da, ds)


def test_pallas_zero_column_block(rng):
    """A block whose trailing column is all zero: the degenerate reflector
    branch leaves a zero pivot (no NaN from the reflector itself), and every
    other block still solves exactly."""
    nb, br, bc = 40, 7, 2
    blocks, x_true, b = _system(rng, nb, br, bc)
    blocks[5, :, 1] = 0.0
    b = np.einsum("bij,bj->bi", blocks, x_true).reshape(-1)
    d = np.asarray(block_rdiag(jnp.asarray(blocks), br, interpret=True)).reshape(nb, bc)
    assert d[5, 1] == 0.0 and np.isfinite(d).all()
    xp = np.asarray(
        block_lstsq(jnp.asarray(blocks), jnp.asarray(b), br, interpret=True)
    ).reshape(nb, bc)
    keep = np.arange(nb) != 5
    np.testing.assert_allclose(xp[keep], x_true[keep], atol=1e-10)


@pytest.mark.parametrize("br,bc", SHAPES)
def test_jnp_recurrence_matches_numpy(rng, br, bc):
    """The plain jax.numpy recurrence (the kernel's reference) against
    NumPy fp64 on both layouts."""
    nb = 200
    blocks, _, b = _system(rng, nb, br, bc)
    noisy = b + rng.normal(size=b.shape)
    want = _lstsq_f64(blocks, noisy)
    xa = np.asarray(block_lstsq_jnp(jnp.asarray(blocks), jnp.asarray(noisy.reshape(nb, br))))
    soa = jnp.asarray(blocks.transpose(1, 2, 0).reshape(br * bc, nb))
    xs = np.asarray(block_lstsq_jnp(soa, jnp.asarray(noisy.reshape(nb, br)), soa=True))
    np.testing.assert_allclose(xa, want, atol=1e-10)
    np.testing.assert_array_equal(xa, xs)
