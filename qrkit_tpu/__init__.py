"""qrkit_tpu — composable structured sparse QR for accelerators, in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the reference
QRKit C++/Eigen library (WACV 2018): QR factorization of block-diagonal,
(row-permuted) block-banded, blocked-thin and block-angular ``[A1 | A2]``
matrices, with Q stored implicitly as compact-WY (Y·T·Yᵀ) Householder blocks and
applied lazily.  The design is accelerator-first:

* per-block dense QR → batched/vmapped compact-WY panel kernels (a fused
  Pallas kernel on the Triton route for tiny blocks on the GPU);
* the banded solver's sequential inter-block carry → ``lax.scan``;
* the OpenMP per-column loops of Q·A → whole-matrix batched matmuls;
* multi-chip scaling → ``jax.sharding.Mesh`` + ``shard_map`` over the block axis
  and TSQR reduction trees whose collectives XLA inserts.

Structure analysis runs host-side (NumPy / native C++) and yields static,
hashable :class:`~qrkit_tpu.plan.StructurePlan` objects keying the jit cache —
the analyzePattern/factorize split of the reference, reborn as a compilation
cache key.
"""

from .plan import BlockInfo, StructurePlan
from .sparse import Permutation, SparseCSR
from .analysis import (
    as_banded_as_possible,
    block_banded_info,
    column_density,
    from_block_banded_pattern,
    from_block_diagonal_pattern,
)
from .containers import BlockDiagonal, BlockMatrix1x2
from .solvers import (
    BandedBlockedQR,
    BlockAngularQR,
    BlockDiagonalQR,
    BlockedThinDenseQR,
    BlockedThinSparseQR,
    ComputationInfo,
    DenseColPivQR,
    DenseHouseholderQR,
    QFormat,
    QRSolver,
    SegmentedBandedQR,
)
from .auto import auto_qr
from .lm import LMConfig, LMResult, levenberg_marquardt
from .persist import load_analysis, plan_from_json, plan_to_json, save_analysis
from .profiling import Timer, count_dispatches, timed, trace

__version__ = "0.1.0"

__all__ = [
    "BlockInfo",
    "StructurePlan",
    "Permutation",
    "SparseCSR",
    "as_banded_as_possible",
    "block_banded_info",
    "column_density",
    "from_block_banded_pattern",
    "from_block_diagonal_pattern",
    "BlockDiagonal",
    "BlockMatrix1x2",
    "BandedBlockedQR",
    "BlockAngularQR",
    "BlockDiagonalQR",
    "BlockedThinDenseQR",
    "BlockedThinSparseQR",
    "ComputationInfo",
    "DenseColPivQR",
    "DenseHouseholderQR",
    "QFormat",
    "QRSolver",
    "SegmentedBandedQR",
    "auto_qr",
    "LMConfig",
    "LMResult",
    "levenberg_marquardt",
    "load_analysis",
    "plan_from_json",
    "plan_to_json",
    "save_analysis",
    "Timer",
    "count_dispatches",
    "timed",
    "trace",
]
