"""Implicit-diff gradients through the fused least-squares solvers.

The custom VJPs (functional._block_diagonal_lstsq_bwd /
_block_angular_lstsq_bwd) implement the implicit-function-theorem gradient of
x* = argmin ||Ax - b||: u = (AᵀA)⁻¹ḡ, ∂b = A u, ∂A = r uᵀ − (A u) x*ᵀ.
Verified here against jax.grad of a dense reference solve (jnp.linalg.solve of
the normal equations, differentiated by ordinary AD) — no finite differences,
the suite runs in fp64.

The reference C++ library has no autodiff story; this is a capability the
design gets from living inside JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qrkit_tpu.functional import block_angular_lstsq, block_diagonal_lstsq

NB, BR, BC = 5, 7, 2


def _dense_from_blocks(blocks):
    nb, br, bc = blocks.shape
    A = jnp.zeros((nb * br, nb * bc), blocks.dtype)
    for i in range(nb):
        A = A.at[i * br : (i + 1) * br, i * bc : (i + 1) * bc].set(blocks[i])
    return A


def _dense_lstsq(A, b):
    return jnp.linalg.solve(A.T @ A, A.T @ b)


@pytest.mark.parametrize("pivot", [False, True])
def test_blockdiag_lstsq_grad_matches_dense(rng, pivot):
    blocks = jnp.asarray(rng.normal(size=(NB, BR, BC)))
    b = jnp.asarray(rng.normal(size=(NB * BR,)))
    w = jnp.asarray(rng.normal(size=(NB * BC,)))  # random cotangent via loss

    def loss_fused(blocks, b):
        return jnp.vdot(w, block_diagonal_lstsq(blocks, b, pivot=pivot))

    def loss_dense(blocks, b):
        return jnp.vdot(w, _dense_lstsq(_dense_from_blocks(blocks), b))

    gB, gb = jax.grad(loss_fused, argnums=(0, 1))(blocks, b)
    gB_ref, gb_ref = jax.grad(loss_dense, argnums=(0, 1))(blocks, b)
    assert np.allclose(np.asarray(gB), np.asarray(gB_ref), atol=1e-8)
    assert np.allclose(np.asarray(gb), np.asarray(gb_ref), atol=1e-8)


def test_blockdiag_lstsq_grad_ignores_b_tail(rng):
    """Tail rows of b beyond nb*br are ignored by the primal — their
    gradient must be exactly zero."""
    blocks = jnp.asarray(rng.normal(size=(NB, BR, BC)))
    b = jnp.asarray(rng.normal(size=(NB * BR + 4,)))
    g = jax.grad(lambda b: jnp.sum(block_diagonal_lstsq(blocks, b)))(b)
    assert np.allclose(np.asarray(g[NB * BR :]), 0.0, atol=0)


def test_block_angular_lstsq_grad_matches_dense(rng):
    m2, tail = 3, 6
    blocks = jnp.asarray(rng.normal(size=(NB, BR, BC)))
    m = NB * BR + tail
    right = jnp.asarray(rng.normal(size=(m, m2)))
    b = jnp.asarray(rng.normal(size=(m,)))
    w = jnp.asarray(rng.normal(size=(NB * BC + m2,)))

    def dense_A(blocks, right):
        A1 = _dense_from_blocks(blocks)
        A1 = jnp.concatenate([A1, jnp.zeros((tail, NB * BC), A1.dtype)], axis=0)
        return jnp.concatenate([A1, right], axis=1)

    def loss_fused(blocks, right, b):
        return jnp.vdot(
            w, block_angular_lstsq(blocks, right, b, n_shards=2, tail=tail)
        )

    def loss_dense(blocks, right, b):
        return jnp.vdot(w, _dense_lstsq(dense_A(blocks, right), b))

    g = jax.grad(loss_fused, argnums=(0, 1, 2))(blocks, right, b)
    g_ref = jax.grad(loss_dense, argnums=(0, 1, 2))(blocks, right, b)
    for got, ref in zip(g, g_ref):
        assert np.allclose(np.asarray(got), np.asarray(ref), atol=1e-8)


def test_blockdiag_lstsq_jvp_consistency(rng):
    """custom_vjp also powers jax.linearize-style use through transpose;
    check a directional derivative against central differences."""
    blocks = np.asarray(rng.normal(size=(NB, BR, BC)))
    b = np.asarray(rng.normal(size=(NB * BR,)))
    dB = np.asarray(rng.normal(size=blocks.shape))
    eps = 1e-6

    def f(B):
        return np.asarray(block_diagonal_lstsq(jnp.asarray(B), jnp.asarray(b)))

    fd = (f(blocks + eps * dB) - f(blocks - eps * dB)) / (2 * eps)
    w = np.asarray(rng.normal(size=(NB * BC,)))
    gB = jax.grad(
        lambda B: jnp.vdot(jnp.asarray(w), block_diagonal_lstsq(B, jnp.asarray(b)))
    )(jnp.asarray(blocks))
    # <w, df/dB . dB> == <grad_B <w,f>, dB>
    assert np.allclose(
        float(np.vdot(w, fd)), float(jnp.vdot(gB, jnp.asarray(dB))), rtol=1e-4
    )
