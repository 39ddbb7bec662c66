"""Fused factorize program builder for the segmented banded solver.

The whole pipeline — panel/slab extraction, phase-1 segment chains (vmapped
XLA scan), lane-major slab Q\u1d40, bottom-row cut, CAQR
compression, boundary chain, health probe — compiles to ONE program per plan
(pinned at 1 dispatch by tests/test_dispatch_count.py).  Split from
segmented_banded.py (round 4); `self` is the SegmentedBandedQR instance.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.householder import panel_qr_yt_soa
from .base import _diag_health
from .banded_blocked import _banded_factorize_chunk
from .segmented_apply import _apply_cols_split, _segment_apply_cols


@functools.partial(jax.jit, static_argnames=("max_carry", "max_emit"))
def _vmapped_chain(C0, shifted, col_inc, active, **kw):
    """vmap of the banded scan chunk over the segment axis."""
    f = lambda c, s, ci, a: _banded_factorize_chunk(c, s, ci, a, **kw)
    return jax.vmap(f)(C0, shifted, col_inc, active)


def build_factorize_fn(self):
    """Per-plan jitted device pipeline: segment chains (vmapped XLA
    scan) → lane-major slab Qᵀ → CAQR-compressed
    boundary chain.  Plan metadata (device-resident index/geometry
    arrays) is constant across the repeated factorizations of one
    structure (the LM pattern), so this compiles once per plan."""
    if getattr(self, "_fac_fn", None) is not None:
        return self._fac_fn
    from .banded_blocked import _shift_panels, banded_factorize

    S, L, o = self.S, self.L, self._overlap
    max_cols, kw, ckw = self._max_cols, dict(self._kw), dict(self._chain_kw)
    nbot2 = self._nbot2
    nloc_max = self._nloc_max
    h1 = kw["max_carry"]

    # NOTE: every device array is a jit ARGUMENT, never a closure capture —
    # a captured device array becomes an MLIR constant, which jax
    # materializes on the HOST at trace time (a device→host fetch) and
    # bakes into the executable, multi-MB at large plans
    self._fac_meta = dict(
        carry_d=self._carry_d, nrows_d=self._nrows_d, starts=self._starts,
        colinc_d=self._colinc_d, carry2d=self._carry2d,
        active_d=self._active_d, rows2d=self._rows2d,
        top_valid=self._top_valid, bot_starts=self._bot_starts,
        bot_valid=self._bot_valid, chain_geom=self._chain_geom_dev,
        emit_d=self._emit_d, seg_col0=self._seg_col0_d,
        chain_cols=self._chain_solve_meta[0],
        chain_emit=self._chain_solve_meta[1],
    )
    pf, sf = self._panel_fast, self._slab_fast
    if pf is not None:
        self._fac_meta["panel_mask"] = pf["mask"]
        if pf["d0"]:
            self._fac_meta["panel_l0shift"] = pf["l0shift"]
    else:
        self._fac_meta["panel_gmap"] = self._panel_gmap
    if sf is not None:
        self._fac_meta["slab_lead_t"] = sf["lead_t"]
        self._fac_meta["slab_tail_t"] = sf["tail_t"]
    else:
        self._fac_meta["slab_gmap_t"] = self._slab_gmap_t
    grouped = self._chain_regroup is not None
    if grouped:
        self._fac_meta["chain_regroup"] = self._chain_regroup
    p2u = self._p2_uniform
    nuni = self._p2_nuni
    p2s = getattr(self, "_p2_static", None) if p2u else None
    p2g = getattr(self, "_p2_gen_static", None) if p2u else None
    if p2u:
        self._fac_meta["s1u"] = self._s1u
        self._fac_meta["s2u"] = self._s2u
        self._fac_meta["spu"] = self._spu

    mR = self._mRloc
    ew = mR * max_cols
    need = S * L * ew

    if pf is not None:
        d0 = pf["d0"]

        def _extract_panels(pad, meta):
            # gather-free: the data vector IS the panel tensor up to a
            # boolean mask (and one static slice for the shifted first
            # panels of segments 1..); see _detect_panel_fast
            data = pad[:-1]
            flat = (
                jnp.concatenate(
                    [data, jnp.zeros((need - data.shape[0],), data.dtype)]
                )
                if data.shape[0] < need
                else data[:need]
            )
            base = jnp.where(
                meta["panel_mask"],
                flat.reshape(S * L, mR, max_cols),
                jnp.zeros((), data.dtype),
            )
            if d0:
                seg = flat.reshape(S, L * ew)
                l0 = jax.lax.slice(seg, (0, d0), (S, d0 + ew)).reshape(
                    S, mR, max_cols
                )
                bs = base.reshape(S, L, mR, max_cols)
                m0 = meta["panel_mask"].reshape(S, L, mR, max_cols)[:, 0]
                sel = meta["panel_l0shift"][:, None, None] & m0
                l0 = jnp.where(sel, l0, bs[:, 0])
                base = bs.at[:, 0].set(l0).reshape(S * L, mR, max_cols)
            return base

    else:

        def _extract_panels(pad, meta):
            return pad[meta["panel_gmap"]]  # [S*L, mR, max_cols]

    if sf is not None:
        w_, mid = sf["w"], self._max_seg_rows - 2 * sf["w"]

        def _extract_slab(pad, meta):
            lead = pad[meta["slab_lead_t"]]
            tail = pad[meta["slab_tail_t"]]
            return jnp.concatenate(
                [lead, jnp.zeros((S, 2 * o, mid), pad.dtype), tail], axis=2
            )

    else:

        def _extract_slab(pad, meta):
            return pad[meta["slab_gmap_t"]]

    def _phase1(pad, meta):
        with jax.named_scope("extract"):
            pj = _extract_panels(pad, meta)  # [S*L, mR, max_cols]
        shifted = _shift_panels(
            pj, meta["carry_d"], meta["nrows_d"], kw["max_active"]
        ).reshape(S, L, kw["max_active"], max_cols)
        C0 = jnp.zeros((S, kw["max_carry"], max_cols), pad.dtype)
        _, (Yws, Ts, Vs) = _vmapped_chain(
            C0, shifted, meta["colinc_d"], meta["active_d"],
            max_carry=kw["max_carry"], max_emit=kw["max_emit"],
        )
        return Yws, Ts, Vs

    rbm = self._rbot_max
    ncols_total, m1 = self.cols, self._m1
    chk = self._health_check_zero_pivot

    def _health(Vs, chain_r, meta):
        # info()'s health probe, folded into the factorize program (the
        # eager r_diagonal assembly costs ~40 tiny dispatches per
        # refactorize) — same scatter as
        # :meth:`r_diagonal`, on the pre-moveaxis [S, L, me, mc] panels
        d = jnp.diagonal(Vs, axis1=2, axis2=3)  # [S, L, k]
        j = jnp.arange(d.shape[2])
        pos = (
            meta["seg_col0"][:, None, None]
            + meta["starts"][:, :, None]
            + j[None, None, :]
        )
        valid = (j[None, None, :] < meta["emit_d"][:, :, None]) & meta[
            "active_d"
        ][:, :, None]
        idx = jnp.where(valid, pos, ncols_total)
        out = jnp.zeros((ncols_total,), d.dtype).at[idx].set(d, mode="drop")
        d2 = jnp.diagonal(chain_r, axis1=1, axis2=2)
        j2 = jnp.arange(d2.shape[1])
        pos2 = m1 + meta["chain_cols"].astype(jnp.int32)[:, None] + j2[None, :]
        valid2 = j2[None, :] < meta["chain_emit"][:, None]
        out = out.at[jnp.where(valid2, pos2, ncols_total)].set(d2, mode="drop")
        return _diag_health(out, check_zero=chk)

    # named scopes mark the stages a profiler trace attributes device time
    # to (examples/profile_segmented.py)
    @jax.jit
    def fac(data, meta):
        dtype = data.dtype
        pad = jnp.concatenate([data, jnp.zeros((1,), dtype)])
        with jax.named_scope("extract"):
            slab_t = _extract_slab(pad, meta)  # [S, 2o, seg_rows(pad)]
        with jax.named_scope("phase1"):
            Yws, Ts, Vs = _phase1(pad, meta)
        with jax.named_scope("phase2_apply"):
            if p2u:
                qt_slab = _apply_cols_split(
                    Yws, Ts, meta, slab_t, h1, True, nuni, p2s, p2g
                )
            else:
                qt_slab = _segment_apply_cols(
                    Yws, Ts, meta["starts"], meta["rows2d"], meta["carry2d"],
                    slab_t, h1, True,
                )
            # stored [S, 2o, nloc] — qt_slab's own layout, no transpose
            j2_top = jnp.where(
                meta["top_valid"][:, None, :],
                qt_slab[:, :, :nloc_max],
                jnp.zeros((), dtype),
            )
            # bottom rows cut straight from the [S, 2o, rows] slab for the
            # batched SoA panel QR (segment axis minor).  Each segment's
            # bottom rows are a CONTIGUOUS run starting at its local column
            # count (by construction, _prepare_segmentation), so the cut is
            # one batched dynamic_slice instead of an element gather.
            qs_pad = jnp.concatenate(
                [qt_slab, jnp.zeros((S, 2 * o, rbm), dtype)], axis=2
            )
            bot = jax.vmap(
                lambda sl, st: jax.lax.dynamic_slice(
                    sl, (jnp.zeros((), st.dtype), st), (2 * o, rbm)
                )
            )(qs_pad, meta["bot_starts"])  # [S, 2o, rbot_max]
            bot = jnp.where(meta["bot_valid"][:, None, :], bot, jnp.zeros((), dtype))
            # chain block 0 has no leading boundary: its local columns are the
            # trailing slab columns (the wrapped leading part is zero)
            bot = bot.at[0].set(jnp.roll(bot[0], -o, axis=0))
        with jax.named_scope("caqr"):
            bot_soa = jnp.transpose(bot, (2, 1, 0))  # [rbot, 2o, S]
            # CAQR compression: ONE batched SoA QR reduces each [rbot, 2o]
            # slab to its [2o, 2o] R factor — batch-parallel (and
            # shard-parallel) — so the sequential boundary chain runs over
            # tiny factors.  Yb stays SoA ([rbot, 2o, S], segments in lanes):
            # the fused solve consumes it that way; protocol paths transpose.
            Yb, Tb_soa, Rb_top = panel_qr_yt_soa(bot_soa)
            Tb = jnp.transpose(Tb_soa, (2, 0, 1))  # [S, 2o, 2o] (small)
            comp = jnp.triu(jnp.transpose(Rb_top, (2, 0, 1)))
        with jax.named_scope("boundary_chain"):
            if grouped:
                compf = jnp.concatenate(
                    [comp.reshape(-1), jnp.zeros((1,), dtype)]
                )
                pan = compf[meta["chain_regroup"]]
            else:
                pan = comp[..., : ckw["max_cols"]]
            chain_seq, chain_r = banded_factorize(
                pan, meta["chain_geom"], **ckw, m=nbot2
            )
        # STORED factor layout is SoA ([L, ma, mc, S] / [L, mc, mc, S],
        # segment axis last); consumers transpose back inside their own
        # jitted programs.
        return (
            jnp.moveaxis(Yws, 0, -1), jnp.moveaxis(Ts, 0, -1),
            jnp.moveaxis(Vs, 0, -1), j2_top, Yb, Tb, chain_seq, chain_r,
            _health(Vs, chain_r, meta),
        )

    self._fac_fn = fac
    return fac

