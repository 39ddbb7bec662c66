"""Segmented banded QR — the sequential chain, parallelized by composition.

The plain banded solver's ``lax.scan`` has inherent per-step latency: a chain
of nb blocks costs nb sequential steps (BandedBlockedSparseQR.h:463-508 has the
same serialization on CPU).  This solver removes it with the *composition* idea
the reference's own paper advertises, arranged for SPMD hardware:

Split the chain into S segments of L blocks.  Declare the first ``o`` columns
of each segment (the overlap shared with the previous segment) **boundary**
columns and the rest **interior**.  Under the column permutation
``P_split = [interior_0, interior_1, ..., | boundaries]`` the matrix becomes
block-angular::

    A · P_split = [ A_I | A_B ]

where ``A_I`` is *block-diagonal over segments* (segment rows touch only their
own interior columns) and ``A_B`` is a thin dense-ish block of boundary
columns.  Then the standard block-angular algorithm applies
(BlockAngularSparseQR.h:458-514):

1. QR of ``A_I``   — S independent banded chains, run as ONE ``vmap`` over the
   segment axis: sequential latency drops from nb steps to L steps.
2. ``J2 = Q1ᵀ A_B`` — batched implicit-Q product.  A_B is *structured*: a
   segment's rows touch only its own two adjacent boundary-column groups
   (≤ 2·o columns), so A_B is stored and transformed as per-segment
   ``[rows, 2o]`` slabs, never as a dense ``[m, S·o]`` operand.
3. QR of the lower rows of J2.  Those rows inherit the slab structure —
   segment s's bottom rows live in boundary columns ``[(s-1)o, (s+1)o)`` —
   so stacked over segments they form ANOTHER banded-blocked matrix: a chain
   of S blocks of ``[rows_bot, 2o]`` stepping o columns.  Phase 3 is therefore
   a recursive (tiny) :func:`banded_factorize` chain instead of one
   ``[m-m1, S·o]`` dense QR — S sequential steps on ``[rows_bot + 2o, 2o]``
   panels.
4. R assembly / permutation composition / two-phase solve (the boundary
   back-substitution is :func:`banded_solve_r` on the chain's R panels).

The same decomposition is the multi-chip distribution of the banded family:
shard the segment axis; only the (tiny) boundary chain crosses segments.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..analysis import as_banded_as_possible, block_banded_info, from_block_banded_pattern
from ..ops.householder import highest_precision
from ..sparse import Permutation, SparseCSR
from .banded_blocked import _banded_solve_chunk
from .base import ComputationInfo, QRSolver
from . import segmented_factorize, segmented_plan, segmented_solve
from .segmented_apply import _seg_q_program, _seg_qt_program
from .segmented_plan import _imap
from .segmented_solve import _interior_backsub_split

__all__ = ["SegmentedBandedQR"]


class SegmentedBandedQR(QRSolver):
    """Banded QR with segment-parallel factorization (drop-in for
    :class:`BandedBlockedQR` on uniform chains; falls back to it otherwise).

    ``segment_blocks`` controls L (blocks per segment).  Requires a uniform
    plan (equal block shapes/steps after merging, the common case for banded
    Jacobians); with ``fallback=True`` (default) non-uniform/short plans
    delegate to a plain :class:`BandedBlockedQR`; with ``fallback=False``
    they raise instead.
    """

    DEFAULT_SEGMENT_BLOCKS = 32  # L; segmentation needs >= 2L blocks

    def __init__(
        self,
        suggested_block_cols: int = 8,
        segment_blocks: int = DEFAULT_SEGMENT_BLOCKS,
        block_rows: Optional[int] = None,
        block_cols: Optional[int] = None,
        block_overlap: Optional[int] = None,
        fallback: bool = True,
        mesh=None,
        axis: str = "dp",
    ):
        self._suggested = suggested_block_cols
        self.L = segment_blocks
        self._static = (
            block_rows is not None and block_cols is not None and block_overlap is not None
        )
        self._brows, self._bcols, self._boverlap = block_rows, block_cols, block_overlap
        self._fallback = fallback
        # distribution: shard the segment axis of every per-segment factor
        # over ``mesh``'s ``axis`` after each compute() — the banded family's
        # multi-chip story (phase 1 partitions with zero communication; only
        # the tiny boundary chain is sequential and stays replicated)
        self.mesh = mesh
        self.axis = axis
        self._delegate = None
        self._analysis_ok = False

    # --- shape ----------------------------------------------------------------------
    @property
    def rows(self) -> int:
        return self._nrows

    @property
    def cols(self) -> int:
        return self._ncols

    # --- analysis -------------------------------------------------------------------
    def analyze_pattern(self, mat: SparseCSR):
        """Segmented analysis; on a non-segmentable plan either delegates to a
        plain :class:`BandedBlockedQR` (``fallback=True``) or raises."""
        self._delegate = None
        self.plan = None
        try:
            return self._analyze_pattern_segmented(mat)
        except ValueError:
            if not self._fallback:
                raise
            from .banded_blocked import BandedBlockedQR

            self._delegate = BandedBlockedQR(
                self._brows, self._bcols, self._boverlap, self._suggested
            )
            if self.plan is not None:
                # segmentation failed AFTER pattern analysis succeeded: hand
                # the plan/row-perm over instead of re-running the O(nnz)
                # ordering + block detection in the delegate
                self._delegate.set_analysis(self.plan, self._row_perm)
            else:
                self._delegate.analyze_pattern(mat)
            self._nrows, self._ncols = mat.shape
            self._analysis_ok = True
            return self

    def set_analysis(self, plan, row_perm: Optional[Permutation] = None):
        """Install a precomputed plan (auto_qr / persist.load_analysis) —
        segment without re-running the O(nnz) ordering + block detection.
        Falls back to a plain delegate like :meth:`analyze_pattern`."""
        self._delegate = None
        self.plan = plan
        self._row_perm = (
            row_perm if row_perm is not None else Permutation.identity(plan.nrows)
        )
        try:
            return self._segment_plan()
        except ValueError:
            if not self._fallback:
                raise
            from .banded_blocked import BandedBlockedQR

            self._delegate = BandedBlockedQR(
                self._brows, self._bcols, self._boverlap, self._suggested
            )
            self._delegate.set_analysis(plan, self._row_perm)
            self._nrows, self._ncols = plan.nrows, plan.ncols
            self._analysis_ok = True
            return self

    def _analyze_pattern_segmented(self, mat: SparseCSR):
        self._nrows, self._ncols = mat.shape
        if self._static:
            self._row_perm = Permutation.identity(mat.nrows)
            self.plan = from_block_banded_pattern(
                mat.nrows, mat.ncols, self._brows, self._bcols, self._boverlap,
                self._suggested,
            )
        else:
            self._row_perm, has_perm = as_banded_as_possible(mat)
            sorted_mat = mat.permute_rows(self._row_perm) if has_perm else mat
            self.plan = block_banded_info(sorted_mat, self._suggested)
        return self._segment_plan()

    def _segment_plan(self):
        return segmented_plan.segment_plan(self)

    def _prepare_segmentation(self):
        return segmented_plan.prepare_segmentation(self)

    def _prepare_p2_gate(self):
        return segmented_plan.prepare_p2_gate(self)

    def compute(self, mat: SparseCSR, force_pattern_analysis: bool = False):
        if not self._analysis_ok or force_pattern_analysis:
            self.analyze_pattern(mat)
        if self._delegate is not None:
            self._delegate.compute(mat)
            self._info = self._delegate._info
            self._health = self._delegate._health
            return self
        S, L = self.S, self.L
        pmat = (
            mat.permute_rows(self._row_perm)
            if not self._row_perm.is_identity()
            else mat
        )
        mR, max_cols = self._mRloc, self._max_cols

        # pattern-only gather maps, built once per plan and kept on device:
        # interior panels [S*L, mR, max_cols] and boundary slabs A_B
        # [S, seg_rows(pad), 2o] (a segment's rows touch only its own two
        # adjacent boundary-column groups) both extract from the raw data
        # vector with a single device gather — per factorize, ONLY that
        # contiguous vector is copied host->device
        o = self._overlap
        fp = pmat.pattern_fingerprint()
        if self._slab_gmap is None or fp != getattr(self, "_gmap_fp", None):
            # keyed on the stored-nonzero LAYOUT, not just the plan — see
            # BandedBlockedQR.compute
            self._gmap_fp = fp
            self._fac_fn = None  # extraction strategy is baked in statically
            # device-resident value path (factorize_values): pattern-only row
            # permutation of the VALUE vector + expected nnz
            self._vals_nnz = mat.nnz
            self._data_perm = (
                None
                if self._row_perm.is_identity()
                else jnp.asarray(
                    mat.row_perm_data_map(self._row_perm).astype(
                        np.int32 if mat.nnz < 2**31 else np.int64
                    )
                )
            )
            gm = pmat.panels_gather_map(self._block_list, mR, max_cols)
            # An element gather through the 4.2M-entry panel map (20k blocks)
            # reads an index per element.  On row-sorted banded layouts every panel's
            # stored entries are ONE contiguous data run at the panel's own
            # linear offset (delta 0), except the leading-overlap-dropping
            # first panel of segments 1.., whose run is shifted by one shared
            # delta.  Detect that on the host (once per layout) and extract
            # with a reshape + boolean mask + one static slice instead of the
            # gather, which moves only the data bytes.
            self._panel_fast = self._detect_panel_fast(gm, pmat.nnz)
            self._panel_gmap = None if self._panel_fast else _imap(gm)
            col_pos = np.full(self._ncols, -1, dtype=np.int64)
            col_pos[self._bcols_idx] = np.arange(self._m2)
            row_ids = np.repeat(np.arange(self._nrows), np.diff(pmat.indptr))
            bp = col_pos[pmat.indices]
            sel = bp >= 0
            r_s = row_ids[sel]
            b_s = bp[sel]
            seg_of = np.searchsorted(self._seg_row0_arr, r_s, side="right") - 1
            seam = b_s // o + 1  # boundary group g sits between segments g and g+1
            lead = seg_of == seam
            ok = lead | (seg_of == seam - 1)  # non-adjacent rows cannot occur
            slabcol = np.where(lead, b_s % o, o + b_s % o)
            gdt = np.int32 if pmat.nnz + 1 < 2**31 else np.int64
            gm = np.full((S, self._max_seg_rows, 2 * o), pmat.nnz, dtype=gdt)
            gm[
                seg_of[ok], (r_s - self._seg_row0_arr[seg_of])[ok], slabcol[ok]
            ] = np.nonzero(sel)[0][ok]
            # lane-major map: gathering through the transposed map yields the
            # slab directly as [S, 2o, seg_rows] — the long axis minor.
            # Only the transposed form goes to the device; the row-major gm
            # stays host-side (the built-flag keeps a cheap sentinel).
            # Boundary columns are touched only by rows NEAR the seams (the
            # first/last blocks of each segment), so ~97% of the map is
            # sentinel; gather just two w-row edge windows and assemble the
            # interior as literal zeros instead of gathering the full map.
            self._slab_gmap = True
            valid_row = (gm < pmat.nnz).any(axis=2)  # [S, seg_rows]
            Rr = self._max_seg_rows
            ridx = np.arange(Rr)[None, :]
            dist = np.where(valid_row, np.minimum(ridx + 1, Rr - ridx), 0)
            w = int(dist.max()) if valid_row.any() else 0
            if 0 < 2 * w <= Rr // 2:
                self._slab_fast = dict(
                    w=w,
                    lead_t=_imap(gm[:, :w, :].transpose(0, 2, 1)),
                    tail_t=_imap(gm[:, Rr - w :, :].transpose(0, 2, 1)),
                )
                self._slab_gmap_t = None
            else:
                self._slab_fast = None
                self._slab_gmap_t = _imap(gm.transpose(0, 2, 1))

        # --- device gather + phases 1-3 as ONE jitted dispatch ----------------------
        # eager glue between the jitted stages would cost ~40 kernel launches
        # per factorize; the whole pipeline is fused into one per-plan
        # compiled program instead
        dtype = np.float32 if not jax.config.jax_enable_x64 else np.float64
        fac = self._get_factorize_fn()
        (self._Yws, self._Ts, self._r_panels, self._j2_top,
         self._Yb, self._Tb, self._chain_seq, self._chain_r, health) = fac(
            jnp.asarray(np.asarray(pmat.data, dtype)), self._fac_meta
        )
        if self.mesh is not None:
            self._place_on_mesh()

        self._set_success(health)
        return self

    def factorize_values(self, values) -> "SegmentedBandedQR":
        """Refactorize from a vector of stored-nonzero VALUES (device-resident
        fast path) — see :meth:`BandedBlockedQR.factorize_values`.  ``values``
        must be in the analyzed matrix's stored order (``mat.data``, length
        ``mat.nnz``); a jax array already on device refactorizes with zero
        host work and zero host→device traffic."""
        if self._delegate is not None:
            self._delegate.factorize_values(values)
            self._info = self._delegate._info
            self._health = self._delegate._health
            return self
        if not self._analysis_ok or self._slab_gmap is None:
            raise ValueError(
                "factorize_values requires a prior compute() on a matrix "
                "with this stored-nonzero layout"
            )
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        vals = jnp.asarray(values)
        if vals.ndim != 1 or vals.shape[0] != self._vals_nnz:
            raise ValueError(
                f"values must be [{self._vals_nnz}] (the analyzed matrix's "
                f"stored-nonzero count), got {vals.shape}"
            )
        if vals.dtype != dtype:
            vals = vals.astype(dtype)
        if self._data_perm is not None:
            vals = vals[self._data_perm]
        fac = self._get_factorize_fn()
        (self._Yws, self._Ts, self._r_panels, self._j2_top,
         self._Yb, self._Tb, self._chain_seq, self._chain_r, health) = fac(
            vals, self._fac_meta
        )
        if self.mesh is not None:
            self._place_on_mesh()
        self._set_success(health)
        return self

    def _place_on_mesh(self):
        """Shard every per-segment factor over the mesh's segment axis.

        The vmapped interior applies/solves then partition over devices with
        no cross-shard traffic; the boundary chain factors (``_chain_seq`` /
        ``_chain_r`` — O(S·o²)) stay replicated, matching the algorithm's
        communication structure.  No-op when S does not tile the mesh."""
        if self.S % self.mesh.devices.size != 0:
            return
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import shard_leading_axis

        (self._Tb, self._j2_top) = shard_leading_axis(
            (self._Tb, self._j2_top), self.mesh, self.axis,
        )
        # SoA stores: the segment axis sits LAST (in lanes)
        def _last(a):
            spec = P(*([None] * (a.ndim - 1) + [self.axis]))
            return jax.device_put(a, NamedSharding(self.mesh, spec))

        self._Yws = _last(self._Yws)
        self._Ts = _last(self._Ts)
        self._Yb = _last(self._Yb)
        self._r_panels = _last(self._r_panels)

    def _detect_panel_fast(self, gm: np.ndarray, nnz: int):
        return segmented_plan.detect_panel_fast(self, gm, nnz)

    def _get_factorize_fn(self):
        return segmented_factorize.build_factorize_fn(self)

    def r_diagonal(self) -> jnp.ndarray:
        """diag(R) in P_split column order: interior panels then the boundary R2."""
        if self._delegate is not None:
            return self._delegate.r_diagonal()
        # SoA store [L, me, mc, S]: diagonal then put segments first
        d = jnp.swapaxes(
            jnp.diagonal(self._r_panels, axis1=1, axis2=2), 0, 1
        )  # [S, L, k]
        k = d.shape[2]
        j = jnp.arange(k)
        pos = (
            self._seg_col0_d[:, None, None]
            + self._starts[:, :, None]
            + j[None, None, :]
        )
        valid = (j[None, None, :] < self._emit_d[:, :, None]) & self._active_d[
            :, :, None
        ]
        n = self.cols
        idx = jnp.where(valid, pos, n)
        out = jnp.zeros((n,), d.dtype).at[idx].set(d, mode="drop")
        # boundary diag from the chain's R panels
        cols_d, emit_d, _ = self._chain_solve_meta
        d2 = jnp.diagonal(self._chain_r, axis1=1, axis2=2)  # [S, k2]
        j2i = jnp.arange(d2.shape[1])
        pos2 = self._m1 + cols_d[:, None] + j2i[None, :]
        valid2 = j2i[None, :] < emit_d[:, None]
        out = out.at[jnp.where(valid2, pos2, n)].set(d2, mode="drop")
        return out

    # --- left (segment) Q ------------------------------------------------------
    def _gather_maps(self):
        """Precompute index maps between global rows and padded segment rows."""
        if hasattr(self, "_seg_gather"):
            return
        S = self.S
        R = self._max_seg_rows
        # padded lanes point OUT of bounds so scatters drop them (an in-bounds
        # sentinel would clobber a real row)
        gather = np.full((S, R), self._nrows, dtype=np.int64)
        valid = np.zeros((S, R), dtype=bool)
        for s in range(S):
            n = self._seg_rows[s]
            gather[s, :n] = self._seg_row0[s] + np.arange(n)
            valid[s, :n] = True
        self._seg_gather = _imap(gather)
        self._seg_valid = jnp.asarray(valid)
        # contiguity fast path: when segments tile [0, nrows) in R-row chunks
        # (every interior segment full, the tail possibly short), the padded
        # per-segment gather of a length-nrows vector is a pad + reshape —
        # an element gather moves indices and values, the reshape is free
        r0 = np.asarray(self._seg_row0, dtype=np.int64)
        sr = np.asarray(self._seg_rows, dtype=np.int64)
        self._seg_contig = bool(
            (r0 == np.arange(S, dtype=np.int64) * R).all()
            and (sr == np.minimum(R, self._nrows - r0)).all()
        )
        # output reordering: all segments' R-rows (n_loc each) first, then rest
        order = []
        for s in range(S):
            order.extend(range(self._seg_row0[s], self._seg_row0[s] + self._seg_ncols[s]))
        for s in range(S):
            order.extend(
                range(self._seg_row0[s] + self._seg_ncols[s], self._seg_row0[s] + self._seg_rows[s])
            )
        self._row_order = _imap(order)
        self._row_order_inv = _imap(np.argsort(np.asarray(order)))

    # --- QRSolver interface -----------------------------------------------------
    def _apply_factors(self):
        """The factor pytree passed into the jitted apply programs — every
        device array is a jit ARGUMENT (a closure-captured device array would
        be baked into the executable as a constant via a host round trip)."""
        return dict(
            Yws=self._Yws, Ts=self._Ts, Yb=self._Yb, Tb=self._Tb,
            chain_seq=self._chain_seq,
        )

    def _apply_meta(self):
        """Per-plan device index maps consumed by the apply programs."""
        self._gather_maps()
        return dict(
            starts=self._starts, rows2d=self._rows2d, carry2d=self._carry2d,
            seg_gather=self._seg_gather, seg_valid=self._seg_valid,
            row_order=self._row_order, row_order_inv=self._row_order_inv,
            rbot_gather=self._rbot_gather, rbot_gather_t=self._rbot_gather_t,
            rbot_valid_t=self._rbot_valid_t, rest_pos=self._rest_pos,
        )

    def _get_apply_fns(self):
        """Jitted one-dispatch Q/Qᵀ matrix programs, cached per plan.

        The old eager composition (per-segment apply → scatter → reorder →
        bottom Qb → chain → scatter) issued ~8 primitive dispatches per
        apply, each with its own launch and host synchronisation."""
        if getattr(self, "_apply_fns", None) is None:
            st = dict(
                S=self.S, R=self._max_seg_rows, nrows=self._nrows,
                m1=self._m1, nbot=self._nbot, nbot2=self._nbot2,
                rbot_max=self._rbot_max, o=self._overlap,
                h1=self._kw["max_carry"],
            )
            self._apply_fns = (
                jax.jit(functools.partial(_seg_qt_program, **st)),
                jax.jit(functools.partial(_seg_q_program, **st)),
            )
        return self._apply_fns

    def apply_qt(self, m: jnp.ndarray) -> jnp.ndarray:
        if self._delegate is not None:
            return self._delegate.apply_qt(m)
        vec = m.ndim == 1
        m2 = m[:, None] if vec else m
        qt, _ = self._get_apply_fns()
        out = qt(self._apply_factors(), self._apply_meta(), m2)
        return out[:, 0] if vec else out

    def apply_q(self, m: jnp.ndarray) -> jnp.ndarray:
        if self._delegate is not None:
            return self._delegate.apply_q(m)
        vec = m.ndim == 1
        m2 = m[:, None] if vec else m
        _, q = self._get_apply_fns()
        out = q(self._apply_factors(), self._apply_meta(), m2)
        return out[:, 0] if vec else out

    # --- sparse-operand Q products (BandedBlockedSparseQR.h:693-700) --------------
    def _sparse_apply_parts(self, transpose: bool):
        """(fill_fn, apply_fn) for the fused sparse Q-product machinery
        (:mod:`~qrkit_tpu.solvers.sparse_apply`)."""
        if self._delegate is not None:
            return self._delegate._sparse_apply_parts(transpose)
        from .sparse_apply import segmented_structural_fill

        def fill(op, row_map):
            return segmented_structural_fill(self, op, transpose, row_map)

        qt, q = self._get_apply_fns()
        return fill, (qt if transpose else q)

    def _sparse_apply_state(self):
        if self._delegate is not None:
            return self._delegate._sparse_apply_state()
        return self._apply_factors(), self._apply_meta()

    def apply_qt_sparse(self, s: SparseCSR) -> SparseCSR:
        """``Qᵀ · S`` for a sparse operand, kept sparse end to end
        (the reference's ``matrixQ().transpose() * spMat``,
        BandedBlockedSparseQR.h:693-700); plan-cached per operand layout."""
        from .sparse_apply import solver_sparse_apply

        return solver_sparse_apply(self, s, True)

    def apply_q_sparse(self, s: SparseCSR) -> SparseCSR:
        """``Q · S`` for a sparse operand (BandedBlockedSparseQR.h:722-729)."""
        from .sparse_apply import solver_sparse_apply

        return solver_sparse_apply(self, s, False)

    def _ensure_col_gather(self):
        """Lazy per-plan column maps: padded per-segment column slot -> global
        column (used by the interior back-substitution and the fused solve)."""
        if hasattr(self, "_col_gather"):
            return
        nloc_max, mc = self._nloc_max, self._max_cols
        cg = np.zeros((self.S, nloc_max + mc), dtype=np.int64)
        cv = np.zeros((self.S, nloc_max + mc), dtype=bool)
        for s in range(self.S):
            n = self._seg_ncols[s]
            cg[s, :n] = self._seg_col0[s] + np.arange(n)
            cv[s, :n] = True
        self._col_gather = _imap(cg)
        self._col_valid = jnp.asarray(cv)
        # run-structure fast path: the R-row block of the solve work vector
        # ([m1], global-column order) is the concatenation of per-segment
        # contiguous runs exactly when each segment's local columns start at
        # the cumulative count — then rhs windows never need the [m1] vector
        # at all (the fused solve reads them straight off the [S, R] apply
        # output and skips a full-length scatter + reorder gather)
        c0 = np.asarray(self._seg_col0, dtype=np.int64)
        nc = np.asarray(self._seg_ncols, dtype=np.int64)
        self._col_runs = bool(
            (c0 == np.concatenate([[0], np.cumsum(nc)[:-1]])).all()
        )

    def solve_r(self, y: jnp.ndarray) -> jnp.ndarray:
        """Two-phase back-substitution: boundary chain, then vmapped interior."""
        if self._delegate is not None:
            return self._delegate.solve_r(y)
        m1, m2 = self._m1, self._m2
        o = self._overlap
        from .banded_blocked import banded_solve_r

        cols_d, emit_d, ncols_d = self._chain_solve_meta
        x2 = banded_solve_r(
            self._chain_r,
            cols_d,
            emit_d,
            ncols_d,
            y[m1 : m1 + m2],
            max_emit=self._chain_kw["max_emit"],
            max_cols=self._chain_kw["max_cols"],
            n=m2,
        )
        # rhs1 = y[:m1] - J2_top x2, via the structured [S, nloc, 2o] slabs
        x2pad = jnp.concatenate(
            [jnp.zeros((o,), x2.dtype), x2, jnp.zeros((o,), x2.dtype)]
        )
        x2seg = x2pad[self._x2_idx]  # [S, 2o]
        contrib = highest_precision(jnp.einsum)("sjn,sj->sn", self._j2_top, x2seg)
        # vmapped per-segment banded back-substitution
        S, L = self.S, self.L
        nloc_max = self._nloc_max
        dt = x2.dtype
        mc = self._max_cols
        self._ensure_col_gather()
        idx_top = jnp.where(
            self._col_valid[:, :nloc_max], self._col_gather[:, :nloc_max], m1
        )
        rhs1 = y[:m1] - jnp.zeros((m1,), dt).at[idx_top].add(contrib, mode="drop")
        ypad = jnp.where(self._col_valid, rhs1[self._col_gather], jnp.zeros((), dt))
        rp_aos = jnp.moveaxis(self._r_panels, -1, 0)
        if self._p2_uniform and self._bs_uniform:
            xs = _interior_backsub_split(
                ypad, rp_aos,
                dict(starts=self._starts, emit2d=self._emit_d,
                     ncols_loc_d=self._ncols_d, active_d=self._active_d,
                     s1u=self._s1u, eru=self._eru, ncu=self._ncu),
                self._max_emit, mc, self._bs_nuni,
                bss=getattr(self, "_bs_static", None),
                bs_gen=getattr(self, "_bs_gen_static", None),
            )
        else:
            xs = jax.vmap(
                lambda xp, yp, rp, cols, er, nc, act: _banded_solve_chunk(
                    xp, yp, rp, cols, er, nc, act,
                    max_emit=self._max_emit, max_cols=mc,
                )
            )(
                jnp.zeros_like(ypad), ypad, rp_aos,
                self._starts, self._emit_d, self._ncols_d, self._active_d,
            )
        idx = jnp.where(self._col_valid, self._col_gather, m1)
        x1 = jnp.zeros((m1,), dt).at[idx].set(xs, mode="drop")
        return jnp.concatenate([x1, x2])

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        """Least-squares solve as ONE compiled dispatch (the protocol-default
        apply_qt → solve_r → back-permutation path issues ~15 eager primitive
        dispatches, each with its own launch overhead)."""
        if self._delegate is not None:
            return self._delegate.solve(b)
        if b.ndim != 1:
            # matrix RHS: fused one-dispatch program for the lane-major k ≤ 16
            # regime; wider RHS take the row-major protocol path
            if 1 <= b.shape[1] <= 16:
                fn = self._get_solve_mat_fn()
                return fn(
                    self._Yws, self._Ts, self._Yb, self._Tb, self._chain_seq,
                    self._chain_r, self._j2_top, self._r_panels, b,
                    self._sol_meta,
                )
            return super().solve(b)
        fn = self._get_solve_fn()
        return fn(
            self._Yws, self._Ts, self._Yb, self._Tb, self._chain_seq,
            self._chain_r, self._j2_top, self._r_panels, b, self._sol_meta,
        )

    def _get_solve_fn(self):
        return segmented_solve.build_solve_fn(self)

    def _get_solve_mat_fn(self):
        return segmented_solve.build_solve_mat_fn(self)

    def matrix_r_dense(self) -> jnp.ndarray:
        """Dense R in the P_split column order (tests)."""
        if self._delegate is not None:
            return self._delegate.matrix_r_dense()
        n = self.cols
        m1, m2, o = self._m1, self._m2, self._overlap
        rp = np.moveaxis(np.asarray(self._r_panels), -1, 0)  # -> [S, L, me, mc]
        R = np.zeros((self._nrows, n), dtype=rp.dtype)
        for s in range(self.S):
            base = int(self._seg_col0[s])
            for j in range(self.L):
                if not self._active[s, j]:
                    continue
                er = int(self._emit[s, j])
                nc = int(self._loc_geom["ncols"][s, j])
                c0 = base + int(self._loc_geom["cols"][s, j])
                R[c0 : c0 + er, c0 : c0 + nc] = rp[s, j, :er, :nc]
        # top-right: the structured J2 slabs scattered to their boundary columns
        # (device store is lane-major [S, 2o, nloc]; row-major here for slicing)
        jt = np.asarray(self._j2_top).transpose(0, 2, 1)
        for s in range(self.S):
            nloc = self._seg_ncols[s]
            r0 = int(self._seg_col0[s])
            for c in range(2 * o):
                gb = (s - 1) * o + c
                if 0 <= gb < m2:
                    R[r0 : r0 + nloc, m1 + gb] = jt[s, :nloc, c]
        # bottom-right: the boundary chain's R panels
        cr = np.asarray(self._chain_r)
        cg = self._chain_geom
        for i in range(len(cg["ncols"])):
            er = int(cg["emit_rows"][i])
            nc = int(cg["ncols"][i])
            c0 = int(cg["cols"][i])
            R[m1 + c0 : m1 + c0 + er, m1 + c0 : m1 + c0 + nc] = cr[i, :er, :nc]
        return jnp.asarray(R)

    def matrix_r_sparse(self):
        """Sparse R (P_split column order) in O(nnz(R)): interior panels +
        structured J2-top slabs + boundary chain panels as triplets."""
        if self._delegate is not None:
            return self._delegate.matrix_r_sparse()
        from ..sparse import SparseCSR

        m1, m2, o = self._m1, self._m2, self._overlap
        trips = []

        # SoA store; row-major [S, L, max_emit, max_cols] for the triplet build
        rp = np.moveaxis(np.asarray(self._r_panels), -1, 0)
        base = (np.asarray(self._seg_col0)[:, None] + self._loc_geom["cols"])[
            :, :, None, None
        ]
        er = self._emit[:, :, None, None]
        nc = self._loc_geom["ncols"][:, :, None, None]
        ri = np.arange(rp.shape[2])[None, None, :, None]
        ci = np.arange(rp.shape[3])[None, None, None, :]
        mask = (
            self._active[:, :, None, None]
            & (ri < er) & (ci < nc) & (ri <= ci) & (rp != 0.0)
        )
        trips.append(
            (
                np.broadcast_to(base + ri, rp.shape)[mask],
                np.broadcast_to(base + ci, rp.shape)[mask],
                rp[mask],
            )
        )

        # device store is lane-major [S, 2o, nloc]; row-major [S, nloc, 2o] here
        jt = np.asarray(self._j2_top).transpose(0, 2, 1)
        rloc = np.asarray(self._seg_col0)[:, None, None] + np.arange(jt.shape[1])[
            None, :, None
        ]
        gb = (np.arange(self.S) - 1)[:, None, None] * o + np.arange(2 * o)[
            None, None, :
        ]
        maskt = (
            (np.arange(jt.shape[1])[None, :, None] < np.asarray(self._seg_ncols)[:, None, None])
            & (gb >= 0) & (gb < m2) & (jt != 0.0)
        )
        trips.append(
            (
                np.broadcast_to(rloc, jt.shape)[maskt],
                m1 + np.broadcast_to(gb, jt.shape)[maskt],
                jt[maskt],
            )
        )

        cr = np.asarray(self._chain_r)  # [S, max_emit2, max_cols2]
        cg = self._chain_geom
        c0 = cg["cols"][:, None, None]
        er2 = cg["emit_rows"][:, None, None]
        nc2 = cg["ncols"][:, None, None]
        ri2 = np.arange(cr.shape[1])[None, :, None]
        ci2 = np.arange(cr.shape[2])[None, None, :]
        mask2 = (ri2 < er2) & (ci2 < nc2) & (ri2 <= ci2) & (cr != 0.0)
        trips.append(
            (
                m1 + np.broadcast_to(c0 + ri2, cr.shape)[mask2],
                m1 + np.broadcast_to(c0 + ci2, cr.shape)[mask2],
                cr[mask2],
            )
        )

        rows = np.concatenate([t[0] for t in trips])
        cols = np.concatenate([t[1] for t in trips])
        vals = np.concatenate([t[2] for t in trips])
        return SparseCSR.from_triplets(rows, cols, vals, (self._nrows, self.cols))

    def cols_permutation(self) -> Permutation:
        if self._delegate is not None:
            return self._delegate.cols_permutation()
        return self._cols_perm

    def rows_permutation(self) -> Permutation:
        if self._delegate is not None:
            return self._delegate.rows_permutation()
        return self._row_perm
