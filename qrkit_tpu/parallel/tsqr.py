"""TSQR — communication-avoiding tall-skinny QR over the device mesh.

The reference has no distributed backend at all (SURVEY §5.8); the block-angular
right block (``Q1ᵀA2``, tall and narrow) is the one place the design *needs*
a cross-device reduction: each shard factors its local row panel independently,
the tiny per-shard R factors are all-gathered, and a second-stage QR of
the stacked Rs produces the global factor.  Written as plain batched jnp ops so
XLA's SPMD partitioner inserts the all-gather when the leading axis is sharded —
no hand-written collectives (the "let XLA insert collectives" recipe).

Implicit Q is the two-level composition
``Q = blkdiag(Q_local_i) · (E Q₂ Eᵀ + I − EEᵀ) · P_selᵀ`` where E embeds the
stacked-R rows; ``apply_q``/``apply_qt`` run it as two compact-WY stages plus
reshapes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.householder import apply_wy, panel_qr_yt
from ..sparse import SparseCSR
from .mesh import shard_leading_axis
from ..solvers.base import ComputationInfo, QRSolver

__all__ = ["tsqr_factorize", "TSQRDenseQR"]


@functools.partial(jax.jit, static_argnames=("n_shards",))
def tsqr_factorize(a: jnp.ndarray, n_shards: int):
    """Two-stage TSQR of [m, n] (m divisible by n_shards; m/n_shards >= n).

    Returns (Yl [s, mloc, n], Tl [s, n, n], Y2 [s*n, n], T2 [n, n], R [n, n]).
    """
    m, n = a.shape
    mloc = m // n_shards
    ab = a.reshape(n_shards, mloc, n)
    Yl, Tl, Rl = jax.vmap(lambda x: panel_qr_yt(x))(ab)  # local stage (per shard)
    r_stack = jnp.triu(Rl)[:, :n].reshape(n_shards * n, n)  # ← the all-gather point
    Y2, T2, R2 = panel_qr_yt(r_stack)  # replicated second stage (tiny)
    return Yl, Tl, Y2, T2, jnp.triu(R2)[:n]


@functools.partial(jax.jit, static_argnames=("n_shards", "transpose"))
def tsqr_apply(Yl, Tl, Y2, T2, v: jnp.ndarray, n_shards: int, transpose: bool):
    """Apply the implicit two-level Q (or Qᵀ) to [m] or [m, k]."""
    vec = v.ndim == 1
    v2 = v[:, None] if vec else v
    k = v2.shape[1]
    s = n_shards
    mloc = Yl.shape[1]
    n = Yl.shape[2]
    if transpose:
        w = jax.vmap(lambda y, t, x: apply_wy(y, t, x, transpose=True))(
            Yl, Tl, v2.reshape(s, mloc, k)
        )
        subset = w[:, :n].reshape(s * n, k)
        rest = w[:, n:].reshape(s * (mloc - n), k)
        z = apply_wy(Y2, T2, subset, transpose=True)
        out = jnp.concatenate([z, rest], axis=0)
    else:
        z = apply_wy(Y2, T2, v2[: s * n])
        subset = z.reshape(s, n, k)
        rest = v2[s * n :].reshape(s, mloc - n, k)
        w = jnp.concatenate([subset, rest], axis=1)
        out = jax.vmap(apply_wy)(Yl, Tl, w).reshape(s * mloc, k)
    return out[:, 0] if vec else out


class TSQRDenseQR(QRSolver):
    """Dense tall-skinny QR distributed over the block/data-parallel mesh axis.

    Drop-in right solver for :class:`~qrkit_tpu.solvers.block_angular.BlockAngularQR`
    — same protocol as :class:`DenseHouseholderQR`, but the local stage runs one
    shard per device when the input rows are sharded.  Rows are zero-padded to a
    multiple of the shard count (padded rows pass through Q untouched).
    """

    def __init__(self, n_shards: int, mesh=None, axis: str = "dp"):
        self.s = n_shards
        self.mesh = mesh
        self.axis = axis

    @property
    def rows(self) -> int:
        return self._m

    @property
    def cols(self) -> int:
        return self._n

    def compute(self, mat) -> "TSQRDenseQR":
        if isinstance(mat, SparseCSR):
            mat = jnp.asarray(mat.to_dense())
        mat = jnp.asarray(mat)
        self._m, self._n = map(int, mat.shape)
        # Choose an effective shard count such that every shard (in particular
        # the last, which absorbs the zero padding at its tail) holds >= n real
        # rows — this keeps padded rows out of the stacked-R subset, so Q acts
        # as identity on them and output truncation is exact.
        s = max(1, self.s)
        while s > 1:
            mloc = max(-(-self._m // s), self._n)
            if self._m - (s - 1) * mloc >= self._n:
                break
            s -= 1
        self._s_eff = s
        mloc = max(-(-self._m // s), self._n)
        self._mpad = mloc * s
        if self._mpad != self._m:
            mat = jnp.concatenate(
                [mat, jnp.zeros((self._mpad - self._m, self._n), mat.dtype)], axis=0
            )
        if self.mesh is not None:
            mat = shard_leading_axis(mat, self.mesh, self.axis)
        self.Yl, self.Tl, self.Y2, self.T2, self._R = tsqr_factorize(mat, s)
        self._info = ComputationInfo.SUCCESS
        return self

    def _pad(self, v):
        if self._mpad == self._m:
            return v
        pad_shape = (self._mpad - self._m,) + v.shape[1:]
        return jnp.concatenate([v, jnp.zeros(pad_shape, v.dtype)], axis=0)

    def apply_q(self, m: jnp.ndarray) -> jnp.ndarray:
        return tsqr_apply(self.Yl, self.Tl, self.Y2, self.T2, self._pad(m), self._s_eff, False)[
            : self._m
        ]

    def apply_qt(self, m: jnp.ndarray) -> jnp.ndarray:
        return tsqr_apply(self.Yl, self.Tl, self.Y2, self.T2, self._pad(m), self._s_eff, True)[
            : self._m
        ]

    def matrix_r_dense(self) -> jnp.ndarray:
        R = jnp.zeros((self._m, self._n), self._R.dtype)
        return R.at[: self._n].set(self._R)

    def solve_r(self, y: jnp.ndarray) -> jnp.ndarray:
        return jax.lax.linalg.triangular_solve(
            self._R, y[:, None], left_side=True, lower=False
        )[:, 0]
