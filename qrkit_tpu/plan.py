"""Static structure plans.

A :class:`StructurePlan` is the analog of the reference's
``analyzePattern`` output (``SparseQRUtils::BlockBandedMatrixInfo``,
/root/reference/src/QRKit/SparseQRUtils.h:179-386).  It is a *hashable, frozen*
host-side object: jitted factorization kernels take it as a static argument, so
re-factorizing matrices with the same structure (the Levenberg-Marquardt pattern)
hits the jit cache — exactly the reference's analyzePattern/factorize split.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["BlockInfo", "StructurePlan"]


@dataclasses.dataclass(frozen=True)
class BlockInfo:
    """Position + size of one dense block (SparseQRUtils.h:95-116)."""

    row: int
    col: int
    nrows: int
    ncols: int

    def astuple(self) -> Tuple[int, int, int, int]:
        return (self.row, self.col, self.nrows, self.ncols)


@dataclasses.dataclass(frozen=True)
class StructurePlan:
    """Block structure of a (possibly row-permuted) block-banded matrix.

    ``blocks`` are in left-to-right column order; ``nnz_q_estimate`` mirrors the
    reference's nonZeroQEstimate.  The plan is hashable so it can key jit caches.
    """

    nrows: int
    ncols: int
    blocks: Tuple[BlockInfo, ...]
    nnz_q_estimate: int = 0

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def max_block_rows(self) -> int:
        return max((b.nrows for b in self.blocks), default=0)

    @property
    def max_block_cols(self) -> int:
        return max((b.ncols for b in self.blocks), default=0)

    def is_uniform(self) -> bool:
        if not self.blocks:
            return True
        b0 = self.blocks[0]
        return all(b.nrows == b0.nrows and b.ncols == b0.ncols for b in self.blocks)

    # Derived geometry used by the banded solver (mirrors the factorize loop
    # geometry of BandedBlockedSparseQR.h:442-519).
    def solved_rows(self) -> Tuple[int, ...]:
        out = []
        for i, b in enumerate(self.blocks):
            if i == self.num_blocks - 1:
                out.append(b.nrows)
            else:
                out.append(self.blocks[i + 1].col - b.col)
        return tuple(out)

    def overlaps(self) -> Tuple[int, ...]:
        """Column overlap between block i and block i+1 (last entry 0)."""
        out = []
        for i, b in enumerate(self.blocks):
            if i == self.num_blocks - 1:
                out.append(0)
            else:
                out.append((b.col + b.ncols) - self.blocks[i + 1].col)
        return tuple(out)

    def as_arrays(self):
        """(row, col, nrows, ncols) int64 arrays — convenient for device metadata."""
        arr = np.asarray([b.astuple() for b in self.blocks], dtype=np.int64)
        if arr.size == 0:
            arr = arr.reshape(0, 4)
        return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
