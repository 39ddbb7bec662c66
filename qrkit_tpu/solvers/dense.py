"""Plain dense QR solvers implementing the QRSolver protocol.

Analogs of the raw Eigen dense solvers the reference plugs into its composite
solvers (``HouseholderQR`` / ``ColPivHouseholderQR``,
/root/reference/test/test-qrkit.cpp:33-50, examples/ellipse_fitting.cpp:35):
a single compact-WY block over the whole matrix.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.householder import (
    apply_wy,
    build_t_factor,
    colpiv_householder_qr,
    panel_qr_yt,
    rank_from_diag,
    rank_masked_triangular_solve,
)
from ..sparse import Permutation, SparseCSR
from .base import ComputationInfo, QRSolver, _diag_health

__all__ = ["DenseHouseholderQR", "DenseColPivQR"]


@functools.partial(jax.jit, static_argnames=("panel_width",))
def _dense_qr(a, panel_width=16):
    return panel_qr_yt(a, panel_width=panel_width)


@jax.jit
def _dense_colpiv_qr(a):
    Y, taus, R, perm = colpiv_householder_qr(a)
    return Y, build_t_factor(Y, taus), R, perm


# compute()-facing variants: triu + the info() health scalar fold into the
# same program, so a dense factorize is exactly ONE dispatch (pinned by
# tests/test_dispatch_count.py)
@functools.partial(jax.jit, static_argnames=("panel_width",))
def _dense_qr_h(a, panel_width=16):
    Y, T, R = panel_qr_yt(a, panel_width=panel_width)
    R = jnp.triu(R)
    return Y, T, R, _diag_health(jnp.diagonal(R), check_zero=True)


@jax.jit
def _dense_colpiv_qr_h(a):
    Y, taus, R, perm = colpiv_householder_qr(a)
    R = jnp.triu(R)
    T = build_t_factor(Y, taus)
    return Y, T, R, perm, _diag_health(jnp.diagonal(R), check_zero=False)


class _DenseQRBase(QRSolver):
    @property
    def rows(self) -> int:
        return self._m

    @property
    def cols(self) -> int:
        return self._n

    def apply_q(self, m: jnp.ndarray) -> jnp.ndarray:
        return apply_wy(self._Y, self._T, m)

    def apply_qt(self, m: jnp.ndarray) -> jnp.ndarray:
        return apply_wy(self._Y, self._T, m, transpose=True)

    def matrix_r_dense(self) -> jnp.ndarray:
        return self._R

    def _square_r(self) -> jnp.ndarray:
        """R's leading [n, n] triangle; for wide input (m < n) the trapezoid
        is embedded in a square with identity dead tail rows so the basic
        solution (x = 0 beyond the pivots) falls out of one triangular solve."""
        m, n = self._m, self._n
        if m >= n:
            return self._R[:n, :n]
        eye_tail = jnp.eye(n, dtype=self._R.dtype)[m:]
        return jnp.concatenate([self._R[:m], eye_tail], axis=0)

    def _padded_rhs(self, y: jnp.ndarray) -> jnp.ndarray:
        n = self._n
        rhs = y[:n]
        if rhs.shape[0] < n:
            rhs = jnp.concatenate(
                [rhs, jnp.zeros((n - rhs.shape[0],), rhs.dtype)]
            )
        return rhs

    def solve_r(self, y: jnp.ndarray) -> jnp.ndarray:
        return jax.lax.linalg.triangular_solve(
            self._square_r(), self._padded_rhs(y)[:, None], left_side=True,
            lower=False,
        )[:, 0]

    @staticmethod
    def _coerce(mat):
        if isinstance(mat, SparseCSR):
            return jnp.asarray(mat.to_dense())
        return jnp.asarray(mat)

    def _adopt_factors(self, m, n, Y, T, R, health) -> None:
        """Populate state from factors computed by an enclosing fused program
        (BlockAngularQR's dense-A2 fast path) — identical post-conditions to
        :meth:`compute`."""
        self._m, self._n = int(m), int(n)
        self._Y, self._T, self._R = Y, T, R
        self._set_success(health)


class DenseHouseholderQR(_DenseQRBase):
    """Blocked dense Householder QR (Eigen::HouseholderQR analog)."""

    def compute(self, mat) -> "DenseHouseholderQR":
        a = self._coerce(mat)
        self._m, self._n = map(int, a.shape)
        self._Y, self._T, self._R, health = _dense_qr_h(a)
        self._set_success(health)
        return self


class DenseColPivQR(_DenseQRBase):
    """Column-pivoted dense QR (Eigen::ColPivHouseholderQR analog)."""

    _health_check_zero_pivot = False  # rank-revealing: deficiency reported via rank()

    def compute(self, mat) -> "DenseColPivQR":
        a = self._coerce(mat)
        self._m, self._n = map(int, a.shape)
        self._Y, self._T, self._R, perm, health = _dense_colpiv_qr_h(a)
        # the pivot order stays a DEVICE array: np.asarray(perm) here would
        # block compute() on a device->host sync, serializing every warm
        # recompute in composite
        # solvers (BlockAngularQR refactorizes one of these per LM iteration)
        self._perm_dev = perm
        self._perm = None
        self._set_success(health)
        return self

    def cols_permutation(self) -> Permutation:
        if self._perm is None:
            self._perm = Permutation(np.asarray(self._perm_dev, dtype=np.int64))
        return self._perm

    def _adopt_factors(self, m, n, Y, T, R, health, perm_dev=None) -> None:
        super()._adopt_factors(m, n, Y, T, R, health)
        self._perm_dev = perm_dev
        self._perm = None

    def solve_r(self, y: jnp.ndarray) -> jnp.ndarray:
        """Rank-aware basic solution: column pivoting clusters dead pivots at
        the tail, so the masked prefix solve is the exact LS minimizer over
        solutions supported on the live pivot columns (wide input included —
        the trapezoid embeds in a square with identity dead rows)."""
        R = self._square_r()
        k = rank_from_diag(
            jnp.diagonal(self._R[: min(self._m, self._n)]), self._m, self._n
        )
        return rank_masked_triangular_solve(R, self._padded_rhs(y), k)

    @property
    def rank(self) -> int:
        d = jnp.diagonal(self._R[: min(self._m, self._n)])
        return int(rank_from_diag(d, self._m, self._n))
