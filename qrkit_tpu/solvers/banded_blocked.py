"""Banded-blocked QR — the sequential chain as a ``lax.scan``.

Accelerator re-design of ``BandedBlockedSparseQR``
(/root/reference/src/QRKit/BandedBlockedSparseQR.h:122-519).  The reference's
sequential left-to-right block loop carries the unsolved overlap columns of each
block's R into the next block's panel (BandedBlockedSparseQR.h:494-507); here
that carry is literally the ``lax.scan`` carry.  Per step: assemble the panel
(carry on top, matrix rows below), compact-WY panel QR, emit solved R rows, and
shift out the next overlap carry.  Q is implicit — a
:class:`~qrkit_tpu.ops.compact_wy.TwoSegmentWYSeq` holding the reflectors in
panel coordinates; the reference's diagonal/subdiagonal segments separated by
``numZeros`` gap rows (BlockYTY.h:77-139, SparseQRUtils.h:44-89) become the
two-slice gather/scatter metadata (carry segment at the R positions, block
segment at the physical rows), keeping the Q store O(nb · panel) instead of
O(nb · window) — the window of a banded chain grows with the chain.

All geometry (active rows, overlaps, gaps) comes from the static
:class:`~qrkit_tpu.plan.StructurePlan`; the jitted factorization is keyed by the
padded maxima, so LM-style repeated factorizations of one structure compile once.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..analysis import as_banded_as_possible, block_banded_info, from_block_banded_pattern
from ..ops.compact_wy import TwoSegmentWYSeq
from ..ops.householder import highest_precision, panel_qr_yt
from ..plan import StructurePlan
from ..sparse import Permutation, SparseCSR
from .base import ComputationInfo, QRSolver, _diag_health

__all__ = ["BandedBlockedQR", "banded_geometry", "banded_factorize", "banded_solve_r"]


def banded_geometry(plan: StructurePlan):
    """Derive per-step scan geometry from the plan.

    Mirrors the loop bookkeeping of BandedBlockedSparseQR.h:457-507:
    ``carry_rows[i]`` = rows of previous R carried into step i,
    ``col_inc[i]``    = column shift applied to produce the next carry,
    ``num_zeros[i]``  = gap rows between the YTY diagonal and subdiagonal parts,
    ``emit_rows[i]``  = R rows owned by block i.
    """
    nb = plan.num_blocks
    rows_, cols_, nrows_, ncols_ = plan.as_arrays()
    carry_rows = np.zeros(nb, dtype=np.int64)
    num_zeros = np.zeros(nb, dtype=np.int64)
    col_inc = np.zeros(nb, dtype=np.int64)
    active = np.zeros(nb, dtype=np.int64)
    active[0] = nrows_[0]
    for i in range(nb - 1):
        overlap = (cols_[i] + ncols_[i]) - cols_[i + 1]
        ci = ncols_[i] - overlap
        col_inc[i] = ci
        # The carry pad serves two roles: it holds the live unsolved R rows of
        # block i (at most min(active, ncols) - ci — R beyond ncols rows is
        # structurally zero, BandedBlockedSparseQR.h:494-507 stacks R's
        # remaining rows), and it reserves window space so the panel's top
        # ncols rows (where the next R accumulates) map contiguously onto the
        # R positions cols[i+1].. of the work vector.  ncols[i+1] rows suffice
        # for the latter; when the physical block starts closer than that
        # (rows-cols gap < ncols) the window is contiguous anyway (nz = 0) and
        # the pad shrinks to the gap.  This bounds the scan-step panel at
        # [nrows + ncols, ncols] instead of the previous [nrows + carry, ncols]
        # with carry = nrows[i] - ci (e.g. 31x10 instead of 36x10 on a
        # 21-row/10-col/overlap-4 chain; 488x8 instead of 956x8 on the
        # segmented solver's boundary chain).
        live = max(min(active[i], ncols_[i]) - ci, 0)
        gapcap = rows_[i + 1] - cols_[i + 1]
        carry_rows[i + 1] = max(live, min(ncols_[i + 1], gapcap))
        active[i + 1] = carry_rows[i + 1] + nrows_[i + 1]
        nz = rows_[i + 1] - carry_rows[i + 1] - cols_[i + 1]
        num_zeros[i + 1] = max(nz, 0)
    solved = np.asarray(plan.solved_rows(), dtype=np.int64)
    emit_rows = np.minimum(solved, ncols_)
    return {
        "carry_rows": carry_rows,
        "col_inc": col_inc,
        "num_zeros": num_zeros,
        "active": active,
        "emit_rows": emit_rows,
        "nrows": nrows_,
        "ncols": ncols_,
        "cols": cols_,
        "rows": rows_,
    }


@functools.partial(jax.jit, static_argnames=("max_carry", "max_emit"))
@highest_precision
def _banded_factorize_chunk(
    C0: jnp.ndarray,  # [max_carry, max_cols] incoming carry
    shifted: jnp.ndarray,  # [L, max_active, max_cols] pre-shifted panels
    col_inc: jnp.ndarray,  # [L]
    active: jnp.ndarray,  # [L] bool — padded tail steps pass the carry through
    *,
    max_carry: int,
    max_emit: int,
):
    """One compiled scan chunk of the banded chain.

    The scan body is structurally minimal (per-step latency bounds long
    chains): panels arrive pre-shifted (the row shift is one batched gather
    outside the scan), the next-carry extraction is a single ``dynamic_slice``
    of the zero-padded R (the out-of-overlap region of a triangular R is
    already zero), and Y is emitted in *panel coordinates* — the placement
    into the work vector (carry segment at the R positions, block segment at
    the physical rows, ``numZeros`` gap between) lives entirely in
    :class:`~qrkit_tpu.ops.compact_wy.TwoSegmentWYSeq` metadata, so nothing
    window-sized is ever materialized.  ``active`` masks padded steps so
    chains of any length reuse one compiled chunk.
    """
    dt = shifted.dtype
    max_cols = shifted.shape[2]

    def body(carry, xs):
        C = carry
        panel_s, ci, act = xs

        Ji = panel_s.at[:max_carry].add(C)
        Y, T, V = panel_qr_yt(Ji)
        V = jnp.triu(V)

        Vp = jnp.pad(V, ((0, max_carry), (0, max_cols)))
        Cn = jax.lax.dynamic_slice(Vp, (ci, ci), (max_carry, max_cols))

        zero = jnp.zeros((), dt)
        Cn = jnp.where(act, Cn, C)
        Y = jnp.where(act, Y, zero)
        T = jnp.where(act, T, zero)
        Vout = jnp.where(act, V[:max_emit], zero)
        return Cn, (Y, T, Vout)

    xs = (shifted, col_inc, active)
    return jax.lax.scan(body, C0, xs)


_CHUNK = 256


def banded_factorize(
    panels: jnp.ndarray,  # [nb, mR, max_cols] dense blocks of the permuted matrix
    geom: dict,  # int32 arrays [nb]: carry_rows, col_inc, nrows, cols, rows
    *,
    max_active: int,
    max_cols: int,
    max_carry: int,
    max_emit: int,
    m: int,
):
    """Banded-chain factorization.  Returns (TwoSegmentWYSeq, R panels [nb, ...]).

    Long chains are processed as fixed-size compiled scan chunks with the
    overlap carry threaded between calls — XLA's compile time grows with scan
    *length*, so one ``_CHUNK``-step program (reused for every chunk
    and every same-shaped plan) keeps compilation bounded while the math is
    identical to a single scan.
    """
    nb, mR, _ = panels.shape
    dt = panels.dtype

    carry_rows = geom["carry_rows"].astype(jnp.int32)
    col_inc = geom["col_inc"].astype(jnp.int32)
    nrows_a = geom["nrows"].astype(jnp.int32)

    shifted = _shift_panels(panels, carry_rows, nrows_a, max_active)

    kw = dict(max_carry=max_carry, max_emit=max_emit)
    C = jnp.zeros((max_carry, max_cols), dt)
    if nb <= _CHUNK + _CHUNK // 2:
        active = jnp.ones((nb,), bool)
        _, (Yws, Ts, Vs) = _banded_factorize_chunk(C, shifted, col_inc, active, **kw)
    else:
        pad = (-nb) % _CHUNK
        def padded(a, fill=0):
            return jnp.concatenate(
                [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0
            )
        shifted_p = padded(shifted)
        ci_p = padded(col_inc)
        act_p = jnp.concatenate([jnp.ones((nb,), bool), jnp.zeros((pad,), bool)])
        ys = []
        for k in range(0, nb + pad, _CHUNK):
            C, y = _banded_factorize_chunk(
                C, shifted_p[k : k + _CHUNK], ci_p[k : k + _CHUNK],
                act_p[k : k + _CHUNK], **kw,
            )
            ys.append(y)
        Yws = jnp.concatenate([y[0] for y in ys])[:nb]
        Ts = jnp.concatenate([y[1] for y in ys])[:nb]
        Vs = jnp.concatenate([y[2] for y in ys])[:nb]

    seq = TwoSegmentWYSeq(
        Yws,
        Ts,
        geom["cols"].astype(jnp.int32),
        geom["rows"].astype(jnp.int32),
        carry_rows,
        h1=max(max_carry, 1),
        m=m,
    )
    return seq, Vs


@functools.partial(jax.jit, static_argnames=("max_active",))
def _shift_panels(panels, carry_rows, nrows_a, max_active: int):
    """Shift each panel down by its carry_rows — one batched gather."""
    nb, mR, _ = panels.shape
    rows_iota = jax.lax.broadcasted_iota(jnp.int32, (max_active,), 0)
    src = rows_iota[None, :] - carry_rows[:, None]
    valid = (src >= 0) & (src < nrows_a[:, None])
    src_c = jnp.clip(src, 0, mR - 1)
    return jnp.where(
        valid[:, :, None],
        jnp.take_along_axis(panels, src_c[:, :, None].astype(jnp.int32), axis=1),
        jnp.zeros((), panels.dtype),
    )


@jax.jit
def _gather_panels(data: jnp.ndarray, gmap: jnp.ndarray) -> jnp.ndarray:
    """Device-side panel extraction: sentinel index nnz reads the appended 0.

    This is the difference between copying the raw nnz data vector
    (contiguous, small) to the device and copying padded dense panels
    (pad_rows*pad_cols per block) every factorize."""
    pad = jnp.concatenate([data, jnp.zeros((1,), data.dtype)])
    return pad[gmap]


@functools.partial(jax.jit, static_argnames=("max_emit", "max_cols"))
@highest_precision
def _banded_solve_chunk(
    xpad: jnp.ndarray,  # [n + max_cols] solution-so-far (carried between chunks)
    ypad: jnp.ndarray,  # [n + max_cols]
    r_panels: jnp.ndarray,  # [L, max_emit, max_cols]
    cols: jnp.ndarray,  # [L]
    emit_rows: jnp.ndarray,  # [L]
    ncols_arr: jnp.ndarray,  # [L]
    active: jnp.ndarray,  # [L]
    *,
    max_emit: int,
    max_cols: int,
):
    dt = r_panels.dtype
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (max_emit,), 0)
    c_iota = jax.lax.broadcasted_iota(jnp.int32, (max_cols,), 0)
    eye = jnp.eye(max_emit, dtype=dt)

    def body(xcarry, xs):
        V, c0, er, nc, act = xs
        # subtract known-x contributions from overlap columns j in [er, nc)
        xwin = jax.lax.dynamic_slice(xcarry, (c0,), (max_cols,))
        maskj = (c_iota >= er) & (c_iota < nc)
        rhs_sub = V[:max_emit] @ jnp.where(maskj, xwin, jnp.zeros((), dt))
        yblk = jax.lax.dynamic_slice(ypad, (c0,), (max_emit,))
        rhs = jnp.where(r_iota < er, yblk - rhs_sub, jnp.zeros((), dt))
        # masked triangular block: padded rows/cols become identity
        live = (r_iota < er)[:, None] & (r_iota < er)[None, :]
        U = jnp.where(live, V[:max_emit, :max_emit], eye)
        xblk = jax.lax.linalg.triangular_solve(
            U, rhs[:, None], left_side=True, lower=False
        )[:, 0]
        old = jax.lax.dynamic_slice(xcarry, (c0,), (max_emit,))
        new = jnp.where((r_iota < er) & act, xblk, old)
        xcarry = jax.lax.dynamic_update_slice(xcarry, new, (c0,))
        return xcarry, None

    xs = (r_panels, cols, emit_rows, ncols_arr, active)
    xpad, _ = jax.lax.scan(body, xpad, xs, reverse=True)
    return xpad


def _rdiag_from_panels(r_panels, cols_d, emit_d, ncols: int) -> jnp.ndarray:
    """diag(R) scattered from [nb, max_emit, max_cols] panels (traceable:
    called inside the fused factorize programs so the health check never
    costs its own dispatches)."""
    d = jnp.diagonal(r_panels, axis1=1, axis2=2)  # [nb, k]
    j = jnp.arange(d.shape[1])
    pos = cols_d.astype(jnp.int32)[:, None] + j[None, :]
    valid = j[None, :] < emit_d[:, None]
    idx = jnp.where(valid, pos, ncols)  # OOB lanes dropped
    return jnp.zeros((ncols,), d.dtype).at[idx].set(d, mode="drop")


def banded_solve_r(
    r_panels: jnp.ndarray,  # [nb, max_emit, max_cols]
    cols: jnp.ndarray,  # [nb] block col offsets
    emit_rows: jnp.ndarray,  # [nb]
    ncols_arr: jnp.ndarray,  # [nb]
    y: jnp.ndarray,  # [n]
    *,
    max_emit: int,
    max_cols: int,
    n: int,
):
    """Blocked back-substitution: reverse scan over blocks (chunked like
    :func:`banded_factorize` to bound compile time on long chains).

    Solves R x = y with the banded upper-triangular R stored as per-block
    panels, without ever materializing R — each step is one [max_emit]²
    triangular solve plus a small matvec against already-solved x entries.
    """
    dt = r_panels.dtype
    nb = r_panels.shape[0]
    xpad = jnp.zeros((n + max_cols,), dt)
    ypad = jnp.concatenate([y, jnp.zeros((max_cols,), dt)])
    cols32 = cols.astype(jnp.int32)
    er32 = emit_rows.astype(jnp.int32)
    nc32 = ncols_arr.astype(jnp.int32)
    kw = dict(max_emit=max_emit, max_cols=max_cols)
    if nb <= _CHUNK + _CHUNK // 2:
        active = jnp.ones((nb,), bool)
        xpad = _banded_solve_chunk(
            xpad, ypad, r_panels, cols32, er32, nc32, active, **kw
        )
    else:
        pad = (-nb) % _CHUNK
        def padded(a):
            return jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
            )
        rp, cp, ep, np_ = padded(r_panels), padded(cols32), padded(er32), padded(nc32)
        act = jnp.concatenate([jnp.ones((nb,), bool), jnp.zeros((pad,), bool)])
        total = nb + pad
        for k in range(total - _CHUNK, -1, -_CHUNK):  # reverse chunk order
            xpad = _banded_solve_chunk(
                xpad, ypad, rp[k : k + _CHUNK], cp[k : k + _CHUNK],
                ep[k : k + _CHUNK], np_[k : k + _CHUNK], act[k : k + _CHUNK],
                **kw,
            )
    return xpad[:n]


class BandedBlockedQR(QRSolver):
    """QR of a (row-permuted) block-banded sparse matrix.

    ``block_rows/block_cols/block_overlap`` given → static known pattern
    (the fixed-size-block fast path, BandedBlockedSparseQR.h:398-408); otherwise
    analyzePattern does abap row ordering + block detection (:417-426).
    """

    def __init__(
        self,
        block_rows: Optional[int] = None,
        block_cols: Optional[int] = None,
        block_overlap: Optional[int] = None,
        suggested_block_cols: int = 2,
    ):
        self._static = block_rows is not None and block_cols is not None and block_overlap is not None
        self._brows = block_rows
        self._bcols = block_cols
        self._boverlap = block_overlap
        self._suggested = suggested_block_cols
        self._analysis_ok = False

    @property
    def rows(self) -> int:
        return self._nrows

    @property
    def cols(self) -> int:
        return self._ncols

    def analyze_pattern(self, mat: SparseCSR):
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
        return self._finish_analysis()

    def set_analysis(self, plan: StructurePlan, row_perm: Optional[Permutation] = None):
        """Install a precomputed plan (e.g. ``persist.load_analysis``) —
        the checkpoint/resume path: factorize without re-running pattern
        analysis on restart (SURVEY §5.4)."""
        self._nrows, self._ncols = plan.nrows, plan.ncols
        self._row_perm = row_perm if row_perm is not None else Permutation.identity(plan.nrows)
        self.plan = plan
        return self._finish_analysis()

    def _finish_analysis(self):
        if self.plan.num_blocks == 0:
            self._info = ComputationInfo.INVALID_INPUT
            raise ValueError(
                "pattern analysis found no blocks (matrix empty or no row is "
                "portrait-mergeable); cannot factorize"
            )
        self.geom = banded_geometry(self.plan)
        g = self.geom
        self._max_active = int(g["active"].max())
        self._max_cols = int(g["ncols"].max())
        self._max_carry = max(int(g["carry_rows"].max()), 1)
        self._max_zeros = int(g["num_zeros"].max())
        self._max_emit = int(g["emit_rows"].max())
        self._mR = int(g["nrows"].max())
        # device-resident copies of the static geometry: transferred ONCE per
        # plan, not per factorize — each small host->device transfer is a
        # synchronous copy, and repeated computes (the LM pattern) would pay
        # six of them per call
        self._geom_dev = {
            k: jnp.asarray(g[k])
            for k in ("carry_rows", "col_inc", "nrows", "cols", "rows")
        }
        self._solve_meta = (
            jnp.asarray(g["cols"]),
            jnp.asarray(g["emit_rows"]),
            jnp.asarray(g["ncols"]),
        )
        self._panel_gmap = None  # pattern gather map, built at first factorize
        self._fac_fn = None
        self._sol_fn = None
        self._analysis_ok = True
        return self

    def compute(self, mat: SparseCSR, force_pattern_analysis: bool = False):
        if not self._analysis_ok or force_pattern_analysis:
            self.analyze_pattern(mat)
        pmat = (
            mat.permute_rows(self._row_perm)
            if not self._row_perm.is_identity()
            else mat
        )
        g = self.geom
        dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
        fp = pmat.pattern_fingerprint()
        if self._panel_gmap is None or fp != self._gmap_fp:
            # keyed on the stored-nonzero LAYOUT, not just the plan: a
            # same-structure matrix with a pruned/reordered entry shifts every
            # later data index, and a stale map would silently gather garbage
            gm = pmat.panels_gather_map(
                [b.astuple() for b in self.plan.blocks],
                self._mR, self._max_cols,
            )
            self._panel_gmap = jnp.asarray(gm)
            self._gmap_fp = fp
            # device-resident value path (factorize_values): cache the row
            # permutation's effect on the VALUE vector (pattern-only) and the
            # expected nnz, so refactorization from an on-device value vector
            # needs zero host work
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
        # per-factorize upload: ONLY the raw data vector (contiguous); panels
        # materialize on device through the cached gather map.  The gather +
        # shift + all scan chunks run as ONE jitted program per plan — the
        # eager chunk-by-chunk glue would cost one launch and host sync per
        # chunk.  Device arrays (gather map, geometry) are jit ARGUMENTS: a
        # closure-captured device array would be baked into the executable
        # as a constant via a device->host copy at trace time.
        self._build_fac_fn()
        data_dev = jnp.asarray(np.asarray(pmat.data, dtype))
        self.q_seq, self._r_panels_f, health = self._run_fac(data_dev)
        self._set_success(health)
        return self

    def _build_fac_fn(self):
        if self._fac_fn is not None:
            return
        mA, mC = self._max_active, self._max_cols
        mCa, mE, m = self._max_carry, self._max_emit, self._nrows
        ncols, chk = self._ncols, self._health_check_zero_pivot

        def _health(Vs, solve_meta):
            # fold the info() health probe into the factorize program: the
            # eager r_diagonal assembly costs ~20 dispatches per refactorize
            cols_d, emit_d, _ = solve_meta
            return _diag_health(
                _rdiag_from_panels(Vs, cols_d, emit_d, ncols), check_zero=chk
            )

        @jax.jit
        def _fac(data, gmap, geom, solve_meta):
            seq, Vs = banded_factorize(
                _gather_panels(data, gmap), geom,
                max_active=mA, max_cols=mC, max_carry=mCa, max_emit=mE, m=m,
            )
            # R panels stored flattened per block, like the WY factors
            # inside seq (see TwoSegmentWYSeq)
            return (
                seq,
                Vs.reshape(Vs.shape[0], -1),
                _health(Vs, solve_meta),
            )

        self._fac_fn = _fac

    def _run_fac(self, vals):
        return self._fac_fn(vals, self._panel_gmap, self._geom_dev, self._solve_meta)

    def factorize_values(self, values) -> "BandedBlockedQR":
        """Refactorize from a vector of stored-nonzero VALUES — the
        analyzePattern/factorize split (BandedBlockedSparseQR.h:170-182)
        taken to its device-resident conclusion.

        One prior :meth:`compute` establishes the pattern, gather maps, and
        compiled program; afterwards each refactorization needs only the
        value vector, in the original matrix's stored-nonzero order
        (``mat.data`` order, length ``mat.nnz``).  Pass a jax array that
        already lives on device — e.g. produced by a jitted Jacobian — and
        the refactorize does ZERO host work and ZERO host→device traffic.
        That skips the host-side dtype conversion and PCIe copy of 4.2M
        values per iteration.  A host NumPy array is also accepted (it
        uploads, exactly like ``compute``)."""
        if not self._analysis_ok or self._fac_fn is None or self._panel_gmap is None:
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
        self.q_seq, self._r_panels_f, health = self._run_fac(vals)
        self._set_success(health)
        return self

    @property
    def r_panels(self) -> jnp.ndarray:
        """R panels as [nb, max_emit, max_cols] (host exports / protocol
        paths; the fused solve consumes the flattened store directly)."""
        return self._r_panels_f.reshape(-1, self._max_emit, self._max_cols)

    def r_diagonal(self) -> jnp.ndarray:
        """diag(R) scattered from the per-block R panels (emit rows partition
        the columns disjointly — plan.solved_rows geometry)."""
        cols_d, emit_d, _ = self._solve_meta
        return _rdiag_from_panels(self.r_panels, cols_d, emit_d, self._ncols)

    # --- Q / R ----------------------------------------------------------------------
    def apply_q(self, m: jnp.ndarray) -> jnp.ndarray:
        return self.q_seq.apply_q(m)

    def apply_qt(self, m: jnp.ndarray) -> jnp.ndarray:
        return self.q_seq.apply_qt(m)

    def matrix_q_sparse(self):
        """Explicit sparse Q (of the row-permuted matrix) via chunked Q·I —
        BandedBlockedSparseQR.h:741-765; see CompactWYSeq.to_sparse_q."""
        return self.q_seq.to_sparse_q()

    # --- sparse-operand Q products (BandedBlockedSparseQR.h:693-700) --------------
    def _sparse_apply_parts(self, transpose: bool):
        """(fill_fn, apply_fn) for the fused sparse Q-product machinery
        (:mod:`~qrkit_tpu.solvers.sparse_apply`)."""
        from .sparse_apply import banded_structural_fill

        geom, nb, m = self.geom, self.plan.num_blocks, self._nrows

        def fill(op, row_map):
            return banded_structural_fill(geom, nb, m, op, transpose, row_map)

        if transpose:
            apply_fn = lambda factors, meta, M: factors.apply_qt(M)  # noqa: E731
        else:
            apply_fn = lambda factors, meta, M: factors.apply_q(M)  # noqa: E731
        return fill, apply_fn

    def _sparse_apply_state(self):
        return self.q_seq, {}

    def apply_qt_sparse(self, s: SparseCSR) -> SparseCSR:
        """``Qᵀ · S`` for a sparse operand, kept sparse end to end — the
        reference's sparse QProduct (``matrixQ().transpose() * spMat``,
        BandedBlockedSparseQR.h:693-700).  Plan-cached per operand layout:
        repeated products issue one fused dispatch + one value fetch."""
        from .sparse_apply import solver_sparse_apply

        return solver_sparse_apply(self, s, True)

    def apply_q_sparse(self, s: SparseCSR) -> SparseCSR:
        """``Q · S`` for a sparse operand (BandedBlockedSparseQR.h:722-729)."""
        from .sparse_apply import solver_sparse_apply

        return solver_sparse_apply(self, s, False)

    def matrix_r_sparse(self):
        """Sparse banded R in O(nnz(R)) straight from the per-block panels
        (the setFromTriplets of BandedBlockedSparseQR.h:483-491, 511-512)."""
        from ..sparse import SparseCSR

        panels = np.asarray(self.r_panels)  # [nb, max_emit, max_cols]
        g = self.geom
        er = g["emit_rows"][:, None, None]
        nc = g["ncols"][:, None, None]
        c0 = g["cols"][:, None, None]
        ri = np.arange(panels.shape[1])[None, :, None]
        ci = np.arange(panels.shape[2])[None, None, :]
        mask = (ri < er) & (ci < nc) & (ri <= ci) & (panels != 0.0)
        rows = np.broadcast_to(c0 + ri, panels.shape)[mask]
        cols = np.broadcast_to(c0 + ci, panels.shape)[mask]
        return SparseCSR.from_triplets(
            rows, cols, panels[mask], (self._nrows, self._ncols)
        )

    def matrix_r_dense(self) -> jnp.ndarray:
        g = self.geom
        R = np.zeros((self._nrows, self._ncols), dtype=np.asarray(self.r_panels).dtype)
        panels = np.asarray(self.r_panels)
        for i, b in enumerate(self.plan.blocks):
            er = int(g["emit_rows"][i])
            nc = int(g["ncols"][i])
            R[b.col : b.col + er, b.col : b.col + nc] = panels[i, :er, :nc]
        return jnp.asarray(R)

    def solve_r(self, y: jnp.ndarray) -> jnp.ndarray:
        cols_d, emit_d, ncols_d = self._solve_meta
        return banded_solve_r(
            self.r_panels,
            cols_d,
            emit_d,
            ncols_d,
            y,
            max_emit=self._max_emit,
            max_cols=self._max_cols,
            n=self._ncols,
        )

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        """Least-squares solve as ONE compiled program per plan (the
        protocol-default eager apply_qt → solve_r path issues one dispatch
        per primitive)."""
        if getattr(self, "_sol_fn", None) is None:
            n, me, mc = self._ncols, self._max_emit, self._max_cols

            @jax.jit
            def _sol(q_seq, r_panels_f, meta, b):
                cols_d, emit_d, ncols_d = meta
                y = q_seq.apply_qt(b)

                def solve1(y1):
                    return banded_solve_r(
                        r_panels_f.reshape(-1, me, mc), cols_d, emit_d,
                        ncols_d, y1, max_emit=me, max_cols=mc, n=n,
                    )

                if b.ndim == 2:  # matrix RHS: batched Qᵀ + vmapped backsub
                    return jax.vmap(solve1, in_axes=1, out_axes=1)(y[:n])
                return solve1(y[:n])

            self._sol_fn = _sol
        return self._sol_fn(self.q_seq, self._r_panels_f, self._solve_meta, b)

    def rows_permutation(self) -> Permutation:
        return self._row_perm
