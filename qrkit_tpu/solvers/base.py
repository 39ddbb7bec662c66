"""The QR-solver protocol shared by every solver (Eigen SparseSolver analog).

The reference composes solvers through C++ template parameters sharing the
SparseSolver concept (``compute/analyzePattern/factorize/solve/matrixQ/matrixR/
colsPermutation/rowsPermutation/rank/info``, e.g.
/root/reference/src/QRKit/BlockDiagonalSparseQR.h:94-313).  Here composition is
Python object composition over this protocol; the heavy lifting inside each
method is jitted device code keyed by the solver's static structure plan.

``matrixQ()`` expression templates become two methods: :meth:`apply_q` /
:meth:`apply_qt` operating on whole matrices (the reference's per-column OpenMP
loops become single batched matmuls).
"""
from __future__ import annotations

import abc
import enum
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse import Permutation

__all__ = ["ComputationInfo", "QRSolver"]


class ComputationInfo(enum.Enum):
    SUCCESS = 0
    NUMERICAL_ISSUE = 1
    INVALID_INPUT = 2
    NOT_COMPUTED = 3


@functools.partial(jax.jit, static_argnames=("check_zero",))
def _diag_health(d: jnp.ndarray, check_zero: bool = True) -> jnp.ndarray:
    """One device scalar: R's leading diagonal is finite (and, for
    non-rank-revealing solvers, nonzero — a silent-NaN hazard there; a
    ColPiv solver handles zero pivots first-class, so deficiency is reported
    via rank(), not as a numerical issue, matching Eigen's info() contract)."""
    ok = jnp.all(jnp.isfinite(d))
    if check_zero:
        ok = jnp.logical_and(ok, jnp.min(jnp.abs(d), initial=jnp.inf) > 0)
    return ok


class QRSolver(abc.ABC):
    """Abstract QR solver: A (row-permuted, col-permuted) = Q R.

    Contract (mirrors the reference):
      * ``P_rows * A * P_cols = Q * R``
      * callers pre-apply ``rows_permutation()`` to RHS vectors before
        :meth:`solve` (test-qrkit.cpp:235, 273-274)
      * :meth:`solve` returns x with ``x[cols_permutation.indices[i]] = y[i]``
        where y solves ``R y = Qᵀ b``.
    """

    _info: ComputationInfo = ComputationInfo.NOT_COMPUTED
    _health = None  # device scalar from _set_success, fetched lazily by info()

    # --- shape ----------------------------------------------------------------------
    @property
    @abc.abstractmethod
    def rows(self) -> int: ...

    @property
    @abc.abstractmethod
    def cols(self) -> int: ...

    @property
    def rank(self) -> int:
        return self.cols

    def info(self) -> ComputationInfo:
        """Factorization status.  The reference's contract is that ``info()``
        reports numerical problems from factorize (BandedBlockedSparseQR.h:335);
        here a one-scalar device-side health check is launched asynchronously at
        the end of ``compute`` and fetched on the first ``info()`` call — the
        factorize path itself never blocks on the device."""
        if self._health is not None:
            healthy = bool(self._health)
            self._health = None
            if not healthy and self._info == ComputationInfo.SUCCESS:
                self._info = ComputationInfo.NUMERICAL_ISSUE
        return self._info

    # Rank-revealing (ColPiv) solvers override this to False: a zero pivot is
    # a first-class, reported condition there, not a numerical issue.
    _health_check_zero_pivot = True

    def _set_success(self, health=None):
        """End-of-compute hook: mark SUCCESS and launch the async health check.

        ``health`` lets a fused factorize program hand over the check scalar
        it already computed on device: the default eager ``r_diagonal()``
        assembly costs ~10-40 tiny dispatches per factorize — pure launch
        overhead — so hot solvers fold the
        diag + finiteness reduction into their single compiled factorize
        program and pass the scalar here (pinned by tests/test_dispatch_count.py)."""
        self._info = ComputationInfo.SUCCESS
        self._health = (
            health
            if health is not None
            else _diag_health(
                self.r_diagonal(), check_zero=self._health_check_zero_pivot
            )
        )

    # --- factorization --------------------------------------------------------------
    @abc.abstractmethod
    def compute(self, mat, **kwargs) -> "QRSolver": ...

    # --- factors --------------------------------------------------------------------
    @abc.abstractmethod
    def apply_q(self, m: jnp.ndarray) -> jnp.ndarray:
        """Q @ m for a vector [rows] or matrix [rows, k]."""

    @abc.abstractmethod
    def apply_qt(self, m: jnp.ndarray) -> jnp.ndarray:
        """Qᵀ @ m."""

    @abc.abstractmethod
    def matrix_r_dense(self) -> jnp.ndarray:
        """Dense R [rows, cols] (tests/interop; large problems use solve_r)."""

    @abc.abstractmethod
    def solve_r(self, y: jnp.ndarray) -> jnp.ndarray:
        """Solve R[:cols,:cols] x = y[:cols] with the structured R."""

    def cols_permutation(self) -> Permutation:
        return Permutation.identity(self.cols)

    def rows_permutation(self) -> Permutation:
        return Permutation.identity(self.rows)

    # --- least squares ----------------------------------------------------------
    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        """Least-squares solve (the _solve_impl shape shared by all reference
        solvers, e.g. BandedBlockedSparseQR.h:290-311): y = Qᵀ b, triangular
        solve on the leading rank×rank block, column back-permutation.

        The caller is responsible for pre-applying ``rows_permutation()`` to b.
        ``b`` may be a vector [rows] or a matrix [rows, k] of RHS columns
        (Eigen's ``solve`` accepts both); the Qᵀ application is batched and
        the structured triangular solve vmaps over the columns.
        """
        if b.ndim == 2:
            y = self.apply_qt(b)  # one batched Qᵀ for every column
            z = jax.vmap(self.solve_r, in_axes=1, out_axes=1)(y[: self.cols])
        else:
            y = self.apply_qt(b)
            z = self.solve_r(y[: self.cols])
        perm = self.cols_permutation()
        if perm.is_identity():
            return z
        gather = jnp.asarray(perm.gather_indices())
        return z[gather]

    def r_diagonal(self) -> jnp.ndarray:
        """Leading diagonal of R as a device array [cols] — structured solvers
        override this so no dense R is ever formed (the default suits solvers
        that already hold R as one dense device array)."""
        return jnp.diagonal(self.matrix_r_dense()[: self.cols, : self.cols])

    # --- diagnostics ----------------------------------------------------------------
    def validate(self, rtol: float = 0.0) -> ComputationInfo:
        """Numerical-health check on the factorization (the reference's
        ``info() == NumericalIssue`` path, set only implicitly there).

        Flags NUMERICAL_ISSUE when R's leading diagonal contains non-finite
        values or entries below ``rtol * max|diag|`` (rank collapse a
        non-rank-revealing solver would silently propagate).  Fully device-side
        via :meth:`r_diagonal` — usable at 500k-block scale.  Updates and
        returns :meth:`info`.
        """
        d = jnp.abs(self.r_diagonal())
        if d.size:
            bad = jnp.logical_or(
                jnp.logical_not(jnp.all(jnp.isfinite(d))),
                jnp.min(d) <= rtol * jnp.max(d),
            )
            if bool(bad):
                self._info = ComputationInfo.NUMERICAL_ISSUE
        return self._info

    def matrix_r_sparse(self):
        """Explicit *sparse* R (the reference's ``matrixR()`` returns a sparse
        matrix, e.g. BandedBlockedSparseQR.h:272-275).  Structured solvers
        override this with an O(nnz(R)) export straight from their panel
        storage; this default densifies first and suits only solvers whose R
        is genuinely dense (thin/dense QR)."""
        from ..sparse import SparseCSR

        R = np.asarray(self.matrix_r_dense())
        r, c = np.nonzero(R)
        return SparseCSR.from_triplets(r, c, R[r, c], R.shape)

    def apply_qt_sparse(self, s):
        """``Qᵀ · S`` for a sparse operand, returned sparse (the reference's
        ``matrixQ().transpose() * SparseMatrix``).  Protocol default densifies
        and prunes exact zeros; the banded family overrides this with
        plan-cached fused programs that never build a dense [m, k]
        intermediate (:mod:`~qrkit_tpu.solvers.sparse_apply`)."""
        from ..sparse import SparseCSR

        out = np.asarray(self.apply_qt(jnp.asarray(s.to_dense())))
        return SparseCSR.from_dense(out)

    def apply_q_sparse(self, s):
        """``Q · S`` for a sparse operand, returned sparse (see
        :meth:`apply_qt_sparse`)."""
        from ..sparse import SparseCSR

        out = np.asarray(self.apply_q(jnp.asarray(s.to_dense())))
        return SparseCSR.from_dense(out)

    # --- parity helpers -------------------------------------------------------------
    def matrix_q_dense(self) -> jnp.ndarray:
        """Explicit dense Q (tests only) = apply_q(I)."""
        return self.apply_q(jnp.eye(self.rows, dtype=self.matrix_r_dense().dtype))

    def matrix_q_sparse(self):
        """Explicit sparse Q.  Structured solvers override with O(nnz(Q))
        exports (two-shifted-diagonal / chunked Q·I); this default goes
        through chunked dense application — fine for the dense/thin solvers
        whose Q is genuinely dense."""
        from ..sparse import SparseCSR

        m = self.rows
        dt = self.matrix_r_dense().dtype
        rows_l, cols_l, vals_l = [], [], []
        chunk = 512
        for c0 in range(0, m, chunk):
            k = min(chunk, m - c0)
            slab = jnp.zeros((m, k), dt).at[c0 + jnp.arange(k), jnp.arange(k)].set(1.0)
            q = np.asarray(self.apply_q(slab))
            r, c = np.nonzero(q)
            rows_l.append(r)
            cols_l.append(c + c0)
            vals_l.append(q[r, c])
        return SparseCSR.from_triplets(
            np.concatenate(rows_l), np.concatenate(cols_l),
            np.concatenate(vals_l), (m, m),
        )
