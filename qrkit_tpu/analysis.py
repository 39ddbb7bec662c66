"""Host-side structure analysis: orderings + block detection.

Re-design of the reference's analysis layer:

* ``column_density``      — SparseQROrdering::ColumnDensity
  (/root/reference/src/QRKit/SparseQROrdering.h:22-50)
* ``as_banded_as_possible`` — SparseQROrdering::AsBandedAsPossible
  (/root/reference/src/QRKit/SparseQROrdering.h:52-120)
* ``block_banded_info``   — SparseQRUtils::BlockBandedMatrixInfo::operator()
  + mergeBlocks (/root/reference/src/QRKit/SparseQRUtils.h:179-386)
* ``from_block_diagonal_pattern`` / ``from_block_banded_pattern`` — the
  known-structure fast paths (SparseQRUtils.h:255-302).

All of it runs on the host over CSR index arrays (NumPy with an optional C++
native backend, see qrkit_tpu/_native.py) and produces a static
:class:`~qrkit_tpu.plan.StructurePlan` that parameterizes the jitted device code.
The analysis is pure pattern work — no floating point — so there is no reason to
put it on the accelerator; it is the "compiler front-end" of the framework.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import _native
from .plan import BlockInfo, StructurePlan
from .sparse import Permutation, SparseCSR

__all__ = [
    "column_density",
    "as_banded_as_possible",
    "block_banded_info",
    "from_block_diagonal_pattern",
    "from_block_banded_pattern",
]


def column_density(mat: SparseCSR) -> Permutation:
    """Column permutation sorting columns by ascending nonzero count (stable).

    Returns P such that ``mat.permute_cols(P)`` has its densest columns last —
    used by the thin sparse QR to push dense columns right.
    """
    counts = mat.col_nnz()
    # Permutation semantics follow Eigen: ``A * P`` gathers columns, so
    # new column i = old column indices[i] — indices is the argsort order.
    order = np.argsort(counts, kind="stable")  # order[newIdx] = origIdx
    return Permutation(order)


def as_banded_as_possible(mat: SparseCSR) -> Tuple[Permutation, bool]:
    """Row permutation stable-sorting rows by their band start column.

    Returns (P, has_permutation); ``mat.permute_rows(P)`` is as-banded-as-possible.
    """
    starts, _ = mat.row_ranges()
    if _native.available():
        indices, has_perm = _native.abap_order(np.ascontiguousarray(starts))
        return Permutation(indices), has_perm
    has_perm = bool(np.any(np.diff(starts) < 0))
    order = np.argsort(starts, kind="stable")  # order[newIdx] = origIdx
    indices = np.empty(mat.nrows, dtype=np.int64)
    indices[order] = np.arange(mat.nrows)
    return Permutation(indices), has_perm


def _merge_blocks(
    blocks: List[BlockInfo], max_col_step: int, suggested_block_cols: int
) -> List[BlockInfo]:
    """Merge candidate blocks into valid portrait panels.

    Faithful to SparseQRUtils.h mergeBlocks (:308-385): merge until each block is
    (a) portrait (nrows > ncols), (b) at least ``max_col_step`` columns wide and
    (c) at least ``suggested_block_cols`` columns wide; blocks column-contained in
    the previous emitted block are folded into it; a trailing remainder that can't
    stand alone is folded into the last emitted block.
    """
    new_blocks: List[BlockInfo] = []
    first: Optional[BlockInfo] = None
    curr_rows = curr_cols = 0

    for curr in blocks:
        if new_blocks:
            last = new_blocks[-1]
            if curr.col + curr.ncols <= last.col + last.ncols:
                new_blocks[-1] = BlockInfo(
                    last.row, last.col, last.nrows + curr.nrows, last.ncols
                )
                continue
        if first is None:
            first = curr
            curr_rows, curr_cols = curr.nrows, curr.ncols
        else:
            curr_rows = curr.row + curr.nrows - first.row
            curr_cols = curr.col + curr.ncols - first.col

        if (
            curr_rows > curr_cols
            and curr_cols >= max_col_step
            and curr_cols >= suggested_block_cols
        ):
            new_blocks.append(BlockInfo(first.row, first.col, curr_rows, curr_cols))
            first = None

    if first is not None:
        if (
            curr_rows > curr_cols
            and curr_cols >= max_col_step
            and curr_cols >= suggested_block_cols
        ):
            new_blocks.append(BlockInfo(first.row, first.col, curr_rows, curr_cols))
        elif new_blocks:
            # fold the remainder into the last emitted block; if nothing was
            # ever emitted, drop it (native qrkit_block_detect semantics —
            # callers raise on an empty plan)
            last = new_blocks[-1]
            new_blocks[-1] = BlockInfo(
                last.row,
                last.col,
                last.nrows + curr_rows,
                first.col + curr_cols - last.col,
            )
    return new_blocks


def block_banded_info(mat: SparseCSR, suggested_block_cols: int = 2) -> StructurePlan:
    """Detect the block-banded structure of an (already row-sorted) matrix.

    Mirrors BlockBandedMatrixInfo::operator() (SparseQRUtils.h:186-253):
    *consecutive runs* of rows sharing a band-start column form candidate
    blocks (width = max band width among the run's rows, height = run length),
    then merged.  Run grouping — not grouping by start value — matches both
    the reference and the native engine on unsorted input.
    """
    starts, ends = mat.row_ranges()
    ncols = mat.ncols

    if _native.available():
        blocks_arr, nnz_q = _native.block_detect(
            mat.nrows, ncols, np.ascontiguousarray(starts),
            np.ascontiguousarray(ends), suggested_block_cols,
        )
        blocks = tuple(BlockInfo(*map(int, b)) for b in blocks_arr)
        return StructurePlan(mat.nrows, mat.ncols, blocks, nnz_q)

    widths = ends - starts + 1

    # maxColStep over consecutive rows (reference includes all rows)
    if mat.nrows > 1:
        steps = np.diff(starts)
        max_col_step = int(steps.max(initial=0))
        max_col_step = max(max_col_step, 0)
    else:
        max_col_step = 0

    blocks: List[BlockInfo] = []
    nnz_q = 0
    i = 0
    nrows = mat.nrows
    while i < nrows:
        s = int(starts[i])
        if s >= ncols:  # empty row: skipped (out-of-band, SparseQRUtils.h)
            i += 1
            continue
        j = i
        w = 0
        while j < nrows and int(starts[j]) == s:
            w = max(w, int(widths[j]))
            j += 1
        blocks.append(BlockInfo(i, s, j - i, w))
        nnz_q += (j - i) * (j - i)
        i = j

    merged = _merge_blocks(blocks, max_col_step, suggested_block_cols)
    return StructurePlan(mat.nrows, mat.ncols, tuple(merged), nnz_q)


def from_block_diagonal_pattern(
    nrows: int, ncols: int, block_rows: int, block_cols: int
) -> StructurePlan:
    """Known block-diagonal structure (SparseQRUtils.h:255-272): no merging."""
    num_blocks = ncols // block_cols
    blocks = tuple(
        BlockInfo(i * block_rows, i * block_cols, block_rows, block_cols)
        for i in range(num_blocks)
    )
    return StructurePlan(nrows, ncols, blocks, num_blocks * block_rows * block_rows)


def from_block_banded_pattern(
    nrows: int,
    ncols: int,
    block_rows: int,
    block_cols: int,
    block_overlap: int,
    suggested_block_cols: int = 2,
) -> StructurePlan:
    """Known block-banded structure with fixed overlap (SparseQRUtils.h:274-302).

    The pattern tiles the matrix: ``ncols`` must equal
    ``num_blocks * (block_cols - block_overlap)`` (the last matrix block
    carries no trailing overlap, matching the reference) and the matrix must
    have at least ``num_blocks * block_rows`` rows (trailing rows beyond the
    tiled region must be structurally zero — Q acts as identity on them).  The
    reference silently mis-factorizes on non-tiling inputs; here that contract
    violation raises — use pattern analysis (omit the static block
    parameters) for irregular shapes.
    """
    max_col_step = block_cols - block_overlap
    num_blocks = ncols // max_col_step
    if ncols % max_col_step != 0 or nrows < num_blocks * block_rows:
        raise ValueError(
            f"static block-banded pattern does not tile a {nrows}x{ncols} "
            f"matrix: need ncols divisible by block_cols-block_overlap="
            f"{max_col_step} and nrows >= num_blocks*block_rows "
            f"({num_blocks}*{block_rows}); run pattern analysis instead"
        )
    blocks = []
    for i in range(num_blocks):
        nc = block_cols if i < num_blocks - 1 else block_cols - block_overlap
        blocks.append(BlockInfo(i * block_rows, i * max_col_step, block_rows, nc))
    merged = _merge_blocks(blocks, max_col_step, suggested_block_cols)
    return StructurePlan(
        nrows, ncols, tuple(merged), num_blocks * block_rows * block_rows
    )
