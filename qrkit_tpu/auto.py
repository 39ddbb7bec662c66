"""Automatic solver selection from detected structure.

The reference requires hand-composed template stacks — the user must know
their Jacobian is block-diagonal/banded/block-angular and write the matching
solver typedef (test-qrkit.cpp:40-57, examples/ellipse_fitting.cpp:126-175).
This facade runs the same structure analysis the solvers use
(AsBandedAsPossible + BlockBandedMatrixInfo, SparseQRUtils.h:186-385;
ColumnDensity, SparseQROrdering.h:22-50) and picks the stack itself:

* block-diagonal plan (zero column overlap)      → :class:`BlockDiagonalQR`
* banded plan (overlapping blocks)               → :class:`BandedBlockedQR`
  (or :class:`SegmentedBandedQR` when asked to prefer the shardable form)
* dense trailing columns over a structured body  → :class:`BlockAngularQR`
  with the dense columns split off as the right block (the ColumnDensity
  rationale, applied automatically)
* no exploitable structure                       → thin/dense QR

`auto_qr(mat)` returns a COMPUTED solver satisfying the usual contract
(``rows_permutation()`` pre-applied by the caller to RHS, column
back-permutation folded into ``cols_permutation()``); the chosen stack is
reported in ``.selection``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .analysis import as_banded_as_possible, block_banded_info
from .containers import BlockDiagonal, BlockMatrix1x2
from .solvers import (
    BandedBlockedQR,
    BlockAngularQR,
    BlockDiagonalQR,
    BlockedThinDenseQR,
    BlockedThinSparseQR,
    DenseColPivQR,
    SegmentedBandedQR,
)
from .solvers.base import QRSolver
from .sparse import Permutation, SparseCSR

__all__ = ["auto_qr", "ColumnSplitQR"]


class ColumnSplitQR(QRSolver):
    """Delegate that feeds the inner solver ``A * P_pre`` and composes the
    permutations, so callers see one solver over the ORIGINAL column order:
    ``P_r A (P_pre ∘ P_inner) = Q R``."""

    def __init__(self, inner: QRSolver, pre: Permutation, selection: str):
        self.inner = inner
        self._pre = pre
        self.selection = selection

    # shape/status delegate
    @property
    def rows(self):
        return self.inner.rows

    @property
    def cols(self):
        return self.inner.cols

    @property
    def rank(self):
        return self.inner.rank

    def info(self):
        return self.inner.info()

    def compute(self, mat, **kwargs):
        raise TypeError("ColumnSplitQR wraps an already-computed solver")

    def apply_q(self, m):
        return self.inner.apply_q(m)

    def apply_qt(self, m):
        return self.inner.apply_qt(m)

    def matrix_r_dense(self):
        return self.inner.matrix_r_dense()

    def matrix_r_sparse(self):
        return self.inner.matrix_r_sparse()

    def matrix_q_sparse(self):
        return self.inner.matrix_q_sparse()  # Q unaffected by column perms

    def solve_r(self, y):
        return self.inner.solve_r(y)

    def r_diagonal(self):
        return self.inner.r_diagonal()

    def rows_permutation(self):
        return self.inner.rows_permutation()

    def cols_permutation(self):
        # (P1 P2).indices[i] = P1.indices[P2.indices[i]]  (A*P gathers columns)
        inner_p = self.inner.cols_permutation()
        return Permutation(self._pre.indices[inner_p.indices])


class BlockDiagonalCSRQR(BlockDiagonalQR):
    """:class:`BlockDiagonalQR` that accepts a raw :class:`SparseCSR` and runs
    the container detection itself (abap row sort + block detection,
    SparseBlockDiagonal.h:95-130) — lets the block-angular composition hand a
    CSR left block straight to a block-diagonal left solver."""

    def __init__(self, suggested_block_cols: int = 3, **kw):
        super().__init__(**kw)
        self._suggested = suggested_block_cols
        self._pre = None

    def set_analysis(self, plan, row_perm):
        """Install a precomputed (uniform block-diagonal) plan so compute()
        skips the O(nnz) ordering + detection (auto_qr already ran them)."""
        self._pre = (plan, row_perm)
        return self

    def compute(self, mat, row_perm=None):
        if isinstance(mat, SparseCSR):
            if self._pre is not None:
                import jax.numpy as jnp

                plan, perm = self._pre
                sorted_mat = (
                    mat.permute_rows(perm) if not perm.is_identity() else mat
                )
                blk = BlockDiagonal(
                    jnp.asarray(
                        sorted_mat.blocks_dense(
                            [b.astuple() for b in plan.blocks],
                            plan.max_block_rows, plan.max_block_cols,
                        )
                    ),
                    mat.nrows, mat.ncols,
                )
                return super().compute(blk, row_perm=perm)
            blk, perm = BlockDiagonal.from_sparse_matrix(mat, self._suggested)
            return super().compute(blk, row_perm=perm)
        return super().compute(mat, row_perm=row_perm)


def _plan_covers(sorted_mat: SparseCSR, plan) -> bool:
    """Every nonzero must fall inside its row-block's column span — a plan
    that under-covers would make the banded solver silently drop entries
    (the reference has the same failure mode and no check at all;
    SparseQRUtils.h:274-302)."""
    rows_, cols_, nrows_, ncols_ = plan.as_arrays()
    row_ids = np.repeat(np.arange(sorted_mat.nrows), np.diff(sorted_mat.indptr))
    pos = np.searchsorted(rows_, row_ids, side="right") - 1
    ok = pos >= 0
    p = np.clip(pos, 0, None)
    inside = (
        ok
        & (row_ids < rows_[p] + nrows_[p])
        & (sorted_mat.indices >= cols_[p])
        & (sorted_mat.indices < cols_[p] + ncols_[p])
    )
    return bool(np.all(inside))


def _csr_solver(
    mat: SparseCSR,
    suggested_block_cols: int,
    prefer_segmented: bool,
):
    """Pick an UNCOMPUTED solver for a plain sparse matrix.

    Returns (solver, selection tag); the analysis already performed here
    (abap ordering + block detection) is INSTALLED on the solver via
    ``set_analysis`` so ``compute()`` will not re-run it.
    """
    perm, has_perm = as_banded_as_possible(mat)
    sorted_mat = mat.permute_rows(perm) if has_perm else mat
    try:
        plan = block_banded_info(sorted_mat, suggested_block_cols)
    except (ValueError, IndexError):
        plan = None
    if plan is not None and not _plan_covers(sorted_mat, plan):
        plan = None
    if plan is not None and plan.num_blocks >= 2:
        rows_, cols_, nrows_, ncols_ = plan.as_arrays()
        ends = cols_ + ncols_
        overlaps = ends[:-1] - cols_[1:]
        br, bc = int(nrows_[0]), int(ncols_[0])
        uniform_diag = (
            np.all(overlaps == 0)
            and np.all(nrows_ == br) and np.all(ncols_ == bc)
            and np.all(rows_ == np.arange(plan.num_blocks) * br)
            and np.all(cols_ == np.arange(plan.num_blocks) * bc)
        )
        if uniform_diag:
            solver = BlockDiagonalCSRQR(suggested_block_cols)
            solver.set_analysis(plan, perm)
            return solver, "block_diagonal"
        if prefer_segmented is False and (
            plan.num_blocks < 2 * SegmentedBandedQR.DEFAULT_SEGMENT_BLOCKS
        ):
            # only short chains keep the plain scan; long chains, tall
            # blocks included (bench_banded.py config3), take the segmented
            # form, whose sequential part is ~nb/L steps instead of nb
            solver = BandedBlockedQR(suggested_block_cols=suggested_block_cols)
            solver.set_analysis(plan, perm)
            return solver, "banded_blocked"
        # the segmented composition is BOTH the shardable form and the
        # single-chip fast form (the vmapped segment batch replaces nb
        # sequential scan steps with ~nb/L); it self-delegates to the plain
        # chain on non-uniform/short plans
        solver = SegmentedBandedQR(suggested_block_cols=suggested_block_cols)
        solver.set_analysis(plan, perm)
        return solver, "segmented_banded"
    if mat.nrows >= 2 * mat.ncols:
        return BlockedThinSparseQR(), "blocked_thin_sparse"
    return DenseColPivQR(), "dense_colpiv"


def auto_qr(
    mat,
    suggested_block_cols: int = 8,
    dense_col_frac: float = 0.25,
    max_angular_cols: Optional[int] = None,
    prefer_segmented: bool = False,
):
    """Analyze ``mat``'s structure, pick the matching solver stack, compute it.

    ``dense_col_frac``: a column with nnz >= this fraction of the rows counts
    as dense; a small set of dense columns over a structured body triggers the
    block-angular split.  Banded plans pick the segmented composition (the
    shardable AND single-chip-fastest form) for chains of >= 64 blocks and
    the plain chain below that; ``prefer_segmented=True`` forces the
    segmented form regardless (it self-delegates when not segmentable).
    """
    if isinstance(mat, BlockDiagonal):
        qr = BlockDiagonalQR().compute(mat)
        qr.selection = "block_diagonal"
        return qr
    if isinstance(mat, BlockMatrix1x2):
        left_solver, tag = (
            _csr_solver(mat.left, suggested_block_cols, prefer_segmented)
            if isinstance(mat.left, SparseCSR)
            else (BlockDiagonalQR(), "block_diagonal")
        )
        qr = BlockAngularQR(left_solver, DenseColPivQR()).compute(mat)
        tag = _effective_tag(left_solver, tag)
        qr.selection = f"block_angular({tag}, dense_colpiv)"
        return qr
    if not isinstance(mat, SparseCSR):
        a = np.asarray(mat)
        qr = (
            BlockedThinDenseQR().compute(a)
            if a.shape[0] >= 4 * a.shape[1]
            else DenseColPivQR().compute(a)
        )
        qr.selection = (
            "blocked_thin_dense" if a.shape[0] >= 4 * a.shape[1] else "dense_colpiv"
        )
        return qr

    m, n = mat.shape
    dense_cols = np.nonzero(mat.col_nnz() >= max(dense_col_frac * m, 2))[0]
    cap = max_angular_cols if max_angular_cols is not None else max(1, n // 8)
    if 0 < dense_cols.size <= cap and dense_cols.size < n - dense_cols.size:
        # block-angular split: structured body | dense trailing columns
        sparse_cols = np.setdiff1d(np.arange(n), dense_cols)
        split = Permutation(np.concatenate([sparse_cols, dense_cols]))
        pm = mat.permute_cols(split)
        n1 = sparse_cols.size
        left = pm.slice_cols(0, n1)
        right = pm.hstack_dense_block(n1, dense_cols.size)
        left_solver, tag = _csr_solver(left, suggested_block_cols, prefer_segmented)
        inner = BlockAngularQR(left_solver, DenseColPivQR()).compute(
            BlockMatrix1x2(left, right)
        )
        tag = _effective_tag(left_solver, tag)
        return ColumnSplitQR(
            inner, split, f"block_angular({tag}, dense_colpiv)"
        )

    solver, tag = _csr_solver(mat, suggested_block_cols, prefer_segmented)
    qr = solver.compute(mat)
    qr.selection = _effective_tag(solver, tag)
    return qr


def _effective_tag(solver, tag: str) -> str:
    """Report the stack that actually ran: SegmentedBandedQR self-delegates to
    its plain BandedBlockedQR on short/non-segmentable plans, and ``selection``
    must describe the effective solver, not the wrapper."""
    if tag == "segmented_banded" and getattr(solver, "_delegate", None) is not None:
        return "banded_blocked"
    return tag
