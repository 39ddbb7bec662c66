"""Structured-matrix containers (device-side, pytree-friendly).

Accelerator analogs of the reference's L2 containers:

* :class:`BlockDiagonal`  — ``SparseBlockDiagonal<BlockMatrixType>``
  (/root/reference/src/QRKit/SparseBlockDiagonal.h:43-163).  Instead of a
  vector of heterogeneous Eigen blocks it stores one dense ``[nb, br, bc]``
  array — the shape a vmapped batched kernel wants.
* :class:`BlockMatrix1x2` — the non-owning ``[Left | Right]`` composite view
  (/root/reference/src/QRKit/BlockMatrix1x2.h:31-67).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .analysis import as_banded_as_possible, block_banded_info
from .sparse import Permutation, SparseCSR

__all__ = ["BlockDiagonal", "BlockMatrix1x2"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BlockDiagonal:
    """Uniform block-diagonal matrix as a stacked dense batch.

    ``blocks[i]`` sits at rows ``i*br``, cols ``i*bc`` of the logical matrix;
    ``nrows/ncols`` may exceed ``nb*br`` / ``nb*bc`` (zero tail rows — the
    reference appends an identity Q tail for those,
    BlockDiagonalSparseQR.h:530-533).

    Storage is either the AoS batch ``[nb, br, bc]`` (the shape a vmapped
    kernel wants for large blocks) or, via :meth:`from_soa`, the lane-major
    SoA form ``[br*bc, nb]`` (entry (r, c) of block i at ``[r*bc + c, i]``),
    which the fused lane-major programs and the block kernel read
    directly.  Either form
    materializes the other lazily through :attr:`blocks` / :meth:`soa`
    (cached outside the pytree so jit signatures stay stable).
    """

    _blocks: Optional[jnp.ndarray]  # [nb, br, bc] or None (SoA storage)
    nrows: int
    ncols: int
    _blocks_soa: Optional[jnp.ndarray] = None  # [br*bc, nb] or None
    _br: Optional[int] = None  # static block shape (SoA storage only)
    _bc: Optional[int] = None

    def __post_init__(self):
        if self._blocks is None and self._blocks_soa is None:
            raise ValueError("BlockDiagonal needs AoS or SoA block storage")

    def tree_flatten(self):
        return (self._blocks, self._blocks_soa), (
            self.nrows, self.ncols, self._br, self._bc,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1], children[1], aux[2], aux[3])

    @classmethod
    def from_soa(
        cls,
        blocks_soa: jnp.ndarray,
        block_rows: int,
        block_cols: int,
        nrows: Optional[int] = None,
        ncols: Optional[int] = None,
    ) -> "BlockDiagonal":
        """Wrap lane-major SoA block storage ``[br*bc, nb]`` (entry (r, c) of
        block i at ``[r*bc + c, i]``) — the resident layout an LM loop should
        keep for small blocks (zero physical padding; feeds the Pallas solver
        tier without relayout)."""
        ebc, nb = blocks_soa.shape
        if ebc != block_rows * block_cols:
            raise ValueError(
                f"SoA row count {ebc} != block_rows*block_cols "
                f"{block_rows * block_cols}"
            )
        return cls(
            None,
            nrows if nrows is not None else nb * block_rows,
            ncols if ncols is not None else nb * block_cols,
            jnp.asarray(blocks_soa),
            block_rows,
            block_cols,
        )

    @property
    def blocks(self) -> jnp.ndarray:
        """AoS batch [nb, br, bc] (materialized lazily from SoA storage)."""
        if self._blocks is not None:
            return self._blocks
        cached = getattr(self, "_aos_cache", None)
        if cached is None:
            br, bc = self._br, self._bc
            cached = jnp.transpose(
                self._blocks_soa.reshape(br, bc, -1), (2, 0, 1)
            )
            object.__setattr__(self, "_aos_cache", cached)
        return cached

    def soa(self) -> jnp.ndarray:
        """Lane-major SoA storage [br*bc, nb] (materialized lazily from AoS)."""
        if self._blocks_soa is not None:
            return self._blocks_soa
        cached = getattr(self, "_soa_cache", None)
        if cached is None:
            nb, br, bc = self._blocks.shape
            cached = jnp.transpose(self._blocks, (1, 2, 0)).reshape(
                br * bc, nb
            )
            object.__setattr__(self, "_soa_cache", cached)
        return cached

    @property
    def is_soa(self) -> bool:
        return self._blocks_soa is not None

    @property
    def num_blocks(self) -> int:
        if self._blocks is not None:
            return self._blocks.shape[0]
        return self._blocks_soa.shape[1]

    @property
    def block_rows(self) -> int:
        return self._blocks.shape[1] if self._blocks is not None else self._br

    @property
    def block_cols(self) -> int:
        return self._blocks.shape[2] if self._blocks is not None else self._bc

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    # --- constructors (mirror SparseBlockDiagonal.h:71-130) -------------------------
    @staticmethod
    def from_block_diagonal_pattern(
        mat: SparseCSR, block_rows: int, block_cols: int
    ) -> "BlockDiagonal":
        """Split an already-block-diagonal sparse matrix into the dense batch."""
        nb = mat.ncols // block_cols
        blocks = mat.blocks_dense(
            [(i * block_rows, i * block_cols, block_rows, block_cols) for i in range(nb)],
            block_rows,
            block_cols,
        )
        return BlockDiagonal(jnp.asarray(blocks), mat.nrows, mat.ncols)

    @staticmethod
    def from_sparse_matrix(
        mat: SparseCSR, suggested_block_cols: int = 3
    ) -> Tuple["BlockDiagonal", Permutation]:
        """Detect block structure in a general sparse matrix (abap row sort +
        block detection, SparseBlockDiagonal.h:95-130) and return the container
        plus the row permutation that was applied."""
        perm, has_perm = as_banded_as_possible(mat)
        sorted_mat = mat.permute_rows(perm) if has_perm else mat
        plan = block_banded_info(sorted_mat, suggested_block_cols)
        if plan.num_blocks == 0:
            raise ValueError("no block structure detected in the matrix")
        br = plan.max_block_rows
        bc = plan.max_block_cols
        # The dense [nb, br, bc] batch assumes block i sits at (i*br, i*bc)
        # with uniform shape; a non-uniform detected plan (e.g. mixed 7- and
        # 9-row blocks) would silently misalign rows here.  The reference's
        # SparseBlockDiagonal keeps per-block offsets and handles it — our
        # banded solver is the right tool for those structures.
        for i, b in enumerate(plan.blocks):
            if (b.nrows, b.ncols, b.row, b.col) != (br, bc, i * br, i * bc):
                raise ValueError(
                    "detected plan is not a uniform block diagonal at "
                    f"(i*{br}, i*{bc}) (block {i} at ({b.row}, {b.col}) is "
                    f"{b.nrows}x{b.ncols}); use BandedBlockedQR instead"
                )
        blocks = sorted_mat.blocks_dense([b.astuple() for b in plan.blocks], br, bc)
        return BlockDiagonal(jnp.asarray(blocks), mat.nrows, mat.ncols), perm

    @staticmethod
    def from_dense_batch(blocks, nrows: Optional[int] = None, ncols: Optional[int] = None):
        blocks = jnp.asarray(blocks)
        nb, br, bc = blocks.shape
        return BlockDiagonal(blocks, nrows or nb * br, ncols or nb * bc)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.asarray(self.blocks).dtype)
        b = np.asarray(self.blocks)
        br, bc = self.block_rows, self.block_cols
        for i in range(self.num_blocks):
            out[i * br : (i + 1) * br, i * bc : (i + 1) * bc] = b[i]
        return out


@dataclasses.dataclass
class BlockMatrix1x2:
    """``[Left | Right]`` composite with heterogeneous halves.

    ``left`` may be a SparseCSR, BlockDiagonal, or dense array; ``right`` is
    typically dense ([m, m2]) or SparseCSR.  Blocks must share a row count
    (BlockMatrix1x2.h:42).

    ``right_t=True`` marks a dense right block stored TRANSPOSED
    (``[m2, m]`` — the m2 angular columns as rows), the layout the
    lane-major fused solver path reads without relayout.
    """

    left: Any
    right: Any
    right_t: bool = False

    def __post_init__(self):
        assert self.left_rows == self.right_rows, "row counts must match"

    @staticmethod
    def _rows(block) -> int:
        if isinstance(block, BlockDiagonal):
            return block.nrows
        if isinstance(block, SparseCSR):
            return block.nrows
        return int(block.shape[0])

    @staticmethod
    def _cols(block) -> int:
        if isinstance(block, BlockDiagonal):
            return block.ncols
        if isinstance(block, SparseCSR):
            return block.ncols
        return int(block.shape[1])

    @property
    def left_rows(self) -> int:
        return self._rows(self.left)

    @property
    def right_rows(self) -> int:
        if self.right_t:
            return int(self.right.shape[1])
        return self._rows(self.right)

    @property
    def left_cols(self) -> int:
        return self._cols(self.left)

    @property
    def right_cols(self) -> int:
        if self.right_t:
            return int(self.right.shape[0])
        return self._cols(self.right)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.left_rows, self.left_cols + self.right_cols)
