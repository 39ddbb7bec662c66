"""Interior back-substitution programs for the segmented banded solver.

Shared-scalar and statically-unrolled variants of the per-segment banded
back-substitution (the general path vmaps banded_blocked._banded_solve_chunk).
Split from segmented_banded.py (round 4); behavior-identical moves.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.householder import highest_precision
from .banded_blocked import _banded_solve_chunk, banded_solve_r
from .segmented_apply import _apply_cols_split, _batched_wy_soa, _segment_apply_cols

@functools.partial(jax.jit, static_argnames=("max_emit", "max_cols"))
@highest_precision
def _banded_solve_chunk_shared(
    ypad, r_panels, cols_u, emit_u, ncols_u, active, *, max_emit: int, max_cols: int
):
    """Uniform-geometry batch form of :func:`_banded_solve_chunk`.

    On a uniform chain every interior segment shares ONE (col-offset,
    emit-rows, ncols) sequence per back-substitution step, so each step's
    solution/RHS windows are cut with a single batch ``dynamic_slice``
    instead of per-segment slices (which vmap lowers to gathers over the
    whole work buffer — that, plus a batched 10×10 ``triangular_solve``,
    made the interior back-substitution most of the fused solve at 20k
    blocks).  The per-block triangular solve is unrolled over the ≤16
    emit rows as lane-wide vector ops; per-segment activity stays a vector
    select.  ``ypad`` [B, nloc+max_cols]; ``r_panels`` [B, L, me, mc];
    shared scalars [L]; ``active`` [B, L]."""
    B = ypad.shape[0]
    dt = r_panels.dtype
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (max_emit,), 0)
    c_iota = jax.lax.broadcasted_iota(jnp.int32, (max_cols,), 0)
    one = jnp.ones((), dt)
    zerov = jnp.zeros((), dt)

    def body(xcarry, xs):
        V, c0, er, nc, act = xs  # V [B, me, mc]; c0/er/nc scalars; act [B]
        zero = jnp.zeros((), c0.dtype)
        xwin = jax.lax.dynamic_slice(xcarry, (zero, c0), (B, max_cols))
        maskj = (c_iota >= er) & (c_iota < nc)
        rhs_sub = jnp.einsum("bec,bc->be", V, jnp.where(maskj[None], xwin, zerov))
        yblk = jax.lax.dynamic_slice(ypad, (zero, c0), (B, max_emit))
        rhs = jnp.where((r_iota < er)[None], yblk - rhs_sub, zerov)
        xcols = [None] * max_emit
        for i in range(max_emit - 1, -1, -1):
            s = rhs[:, i]
            for j in range(i + 1, max_emit):
                s = s - V[:, i, j] * xcols[j]
            xi = s / jnp.where(i < er, V[:, i, i], one)
            xcols[i] = jnp.where(i < er, xi, zerov)
        xblk = jnp.stack(xcols, axis=1)  # [B, me]
        old = jax.lax.dynamic_slice(xcarry, (zero, c0), (B, max_emit))
        new = jnp.where((r_iota < er)[None] & act[:, None], xblk, old)
        return jax.lax.dynamic_update_slice(xcarry, new, (zero, c0)), None

    Vl = jnp.moveaxis(r_panels, 0, 1)  # [L, B, me, mc]
    xpad, _ = jax.lax.scan(
        body,
        jnp.zeros_like(ypad),
        (Vl, cols_u, emit_u, ncols_u, active.T),
        reverse=True,
    )
    return xpad


def _banded_solve_chunk_shared_static(
    ypad, r_panels, colst, emitt, ncolst, active, *, max_cols: int
):
    """Statically-unrolled form of :func:`_banded_solve_chunk_shared`.

    The shared (col-offset, emit-rows, ncols) sequences are PLAN data, so
    every window cut/update is a static slice (XLA keeps the solution buffer
    in place) and the per-step triangular solve unrolls only the step's
    ``er`` real rows — the ``lax.scan`` form pays a step latency per
    block.  Inactive
    steps of padded segments are masked by ``active`` exactly as in the scan
    form (their zero pivots produce non-finite lanes that the select drops);
    ``active=None`` asserts every step is live (the trimmed general-segment
    tuples)."""
    B = ypad.shape[0]
    dt = r_panels.dtype
    L = len(colst)
    zerov = jnp.zeros((), dt)
    xpad = jnp.zeros_like(ypad)
    cj = np.arange(max_cols)
    for l in range(L - 1, -1, -1):
        c0, er, nc = int(colst[l]), int(emitt[l]), int(ncolst[l])
        if er == 0:
            continue
        V = r_panels[:, l]  # [B, me, mc]
        xwin = jax.lax.slice(xpad, (0, c0), (B, c0 + max_cols))
        maskj = (cj >= er) & (cj < nc)
        rhs_sub = highest_precision(jnp.einsum)(
            "bec,bc->be",
            V[:, :er, :],
            jnp.where(jnp.asarray(maskj)[None], xwin, zerov),
        )
        rhs = jax.lax.slice(ypad, (0, c0), (B, c0 + er)) - rhs_sub
        xcols = [None] * er
        for i in range(er - 1, -1, -1):
            s = rhs[:, i]
            for j in range(i + 1, er):
                s = s - V[:, i, j] * xcols[j]
            xcols[i] = s / V[:, i, i]
        xblk = jnp.stack(xcols, axis=1)  # [B, er]
        if active is not None:
            xblk = jnp.where(
                active[:, l][:, None],
                xblk,
                jax.lax.slice(xpad, (0, c0), (B, c0 + er)),
            )
        xpad = jax.lax.dynamic_update_slice(xpad, xblk, (0, c0))
    return xpad


def _interior_backsub_split(
    ypad, r_panels, meta, max_emit: int, max_cols: int, nuni: int,
    bss=None, bs_gen=None,
):
    """Interior back-substitution on uniform plans: segments ``1..1+nuni``
    run the shared-scalar batch path; segment 0 and irregular tail segments
    run the general vmapped per-segment chunk (mirrors
    :func:`_apply_cols_split`).  ``bss``/``bs_gen`` carry the shared / the
    per-general-segment scalar sequences as host tuples when available,
    selecting the unrolled-static forms.  Returns ``xs`` [S, nloc+max_cols]."""
    S = ypad.shape[0]
    e = 1 + nuni
    gi = np.array([0] + list(range(e, S)))
    if bs_gen is not None and len(bs_gen) == len(gi):
        yg, rg = ypad[gi], r_panels[gi]
        outs_g = []
        for k in range(len(gi)):
            ct, et, nt = bs_gen[k]
            n = len(ct)
            outs_g.append(
                _banded_solve_chunk_shared_static(
                    yg[k : k + 1], rg[k : k + 1, :n], ct, et, nt, None,
                    max_cols=max_cols,
                )
            )
        xs_g = jnp.concatenate(outs_g, axis=0)
    else:
        xs_g = jax.vmap(
            lambda xp, yp, rp, cs, er, nc, act: _banded_solve_chunk(
                xp, yp, rp, cs, er, nc, act, max_emit=max_emit, max_cols=max_cols
            )
        )(
            jnp.zeros_like(ypad[gi]), ypad[gi], r_panels[gi], meta["starts"][gi],
            meta["emit2d"][gi], meta["ncols_loc_d"][gi], meta["active_d"][gi],
        )
    if bss is not None:
        xs_u = _banded_solve_chunk_shared_static(
            ypad[1:e], r_panels[1:e], bss[0], bss[1], bss[2],
            meta["active_d"][1:e], max_cols=max_cols,
        )
    else:
        xs_u = _banded_solve_chunk_shared(
            ypad[1:e], r_panels[1:e], meta["s1u"], meta["eru"], meta["ncu"],
            meta["active_d"][1:e], max_emit=max_emit, max_cols=max_cols,
        )
    return jnp.concatenate([xs_g[:1], xs_u, xs_g[1:]], axis=0)


def build_solve_fn(self):
    if getattr(self, "_solve_fn", None) is not None:
        return self._solve_fn
    from .banded_blocked import banded_solve_r

    self._gather_maps()
    self._ensure_col_gather()  # lazy per-plan solve maps (shared with solve_r)

    m1, m2, o = self._m1, self._m2, self._overlap
    S, mc, nloc_max = self.S, self._max_cols, self._nloc_max
    ckw = dict(self._chain_kw)
    h1 = self._kw["max_carry"]
    nrows_tot, max_emit = self._nrows, self._max_emit
    perm = self._cols_perm
    has_perm = not perm.is_identity()
    nbot, nbot2 = self._nbot, self._nbot2

    cols_d, emit_d, ncols_d = self._chain_solve_meta
    p2u = self._p2_uniform
    nuni = self._p2_nuni
    p2s = getattr(self, "_p2_static", None) if p2u else None
    p2g = getattr(self, "_p2_gen_static", None) if p2u else None
    # every device array is a jit argument — see _get_factorize_fn
    self._sol_meta = dict(
        starts=self._starts, rows2d=self._rows2d, carry2d=self._carry2d,
        cols_d=cols_d, emit_d=emit_d, ncols_d=ncols_d,
        x2_idx=self._x2_idx, ncols_loc_d=self._ncols_d,
        active_d=self._active_d, emit2d=self._emit_d,
        seg_gather=self._seg_gather, seg_valid=self._seg_valid,
        row_order=self._row_order, rbot_gather_t=self._rbot_gather_t,
        rbot_valid_t=self._rbot_valid_t, col_gather=self._col_gather,
        col_valid=self._col_valid,
    )
    if has_perm:
        self._sol_meta["gather_cols"] = jnp.asarray(perm.gather_indices())
    if p2u:
        self._sol_meta["s1u"] = self._s1u
        self._sol_meta["s2u"] = self._s2u
        self._sol_meta["spu"] = self._spu
    bsu = p2u and self._bs_uniform
    bs_nuni = self._bs_nuni if bsu else 0
    bss = getattr(self, "_bs_static", None) if bsu else None
    bsg = getattr(self, "_bs_gen_static", None) if bsu else None
    if bsu:
        self._sol_meta["eru"] = self._eru
        self._sol_meta["ncu"] = self._ncu
    # segment-space fast paths (see _gather_maps/_ensure_col_gather):
    # seg_contig lets the input gather become pad+reshape; col_runs lets
    # the whole pipeline stay in [S, R] segment space — the bottom
    # windows are batched dynamic slices of the apply output and the
    # interior rhs is formed per segment, skipping the full-length
    # scatter, the R-rows-first reorder gather, and the [rbot_max, S]
    # bottom gather (three ~100k-element index ops)
    seg_contig = self._seg_contig
    col_runs = self._col_runs
    R_seg, rbm = self._max_seg_rows, self._rbot_max
    if col_runs:
        self._sol_meta["bot_starts"] = self._bot_starts
        self._sol_meta["rbot_valid"] = self._rbot_valid

    # named scopes mark the stages a profiler trace attributes device time
    # to (examples/profile_segmented.py)
    @jax.jit
    def sol(Yws, Ts, Yb, Tb, chain_seq, chain_r, j2_top, r_panels, b, meta):
        dt = b.dtype
        # stored factors arrive SoA (segment axis last, unpadded store);
        # the AoS working form here is jit-internal, compiler-laid-out
        with jax.named_scope("interior_qt"):
            Yws = jnp.moveaxis(Yws, -1, 0)
            Ts = jnp.moveaxis(Ts, -1, 0)
            r_panels = jnp.moveaxis(r_panels, -1, 0)
            seg_gather, seg_valid = meta["seg_gather"], meta["seg_valid"]
            col_gather, col_valid = meta["col_gather"], meta["col_valid"]
            # Q1ᵀ b (per-segment), lane-major ([S, 1, rows]: the long axis
            # minor, as the narrow-operand applies expect)
            if seg_contig:
                vt = jnp.pad(b, (0, S * R_seg - nrows_tot)).reshape(
                    S, 1, R_seg
                )
            else:
                vt = jnp.where(
                    seg_valid[:, None, :],
                    b[jnp.clip(seg_gather, 0, nrows_tot - 1)][:, None, :],
                    jnp.zeros((), dt),
                )
            out = (
                _apply_cols_split(Yws, Ts, meta, vt, h1, True, nuni, p2s, p2g)
                if p2u
                else _segment_apply_cols(
                    Yws, Ts, meta["starts"], meta["rows2d"], meta["carry2d"],
                    vt, h1, True,
                )
            )
            # compressed boundary reduction Qᵀ + back-substitution: only the
            # chain-space rows matter for x2, so the pass-through rows of the
            # full _bot_qt are skipped — and the whole apply runs in the SoA
            # layout Yb is stored in ([rbot, 2o, S], segments in lanes),
            # forming only the 2o chain-space output rows
            if col_runs:
                # segment-space form: bottom windows are per-segment
                # contiguous runs of the apply output right after the local
                # R rows — one batched dynamic slice, no [nrows] scatter +
                # reorder gather + [rbot_max, S] bottom gather
                out2 = out[:, 0, :]  # [S, R]
                outp = jnp.concatenate(
                    [out2, jnp.zeros((S, rbm), dt)], axis=1
                )
                wrows = jax.vmap(
                    lambda row, st: jax.lax.dynamic_slice(row, (st,), (rbm,))
                )(outp, meta["bot_starts"])
                wrows = jnp.where(meta["rbot_valid"], wrows, jnp.zeros((), dt))
                w = wrows.T[:, None, :]  # [rbot_max, 1, S]
            else:
                scat = jnp.zeros((nrows_tot,), dt)
                scat = scat.at[seg_gather.reshape(-1)].set(
                    out[:, 0, :].reshape(-1), mode="drop"
                )
                top = scat[meta["row_order"]]
                w = jnp.where(
                    meta["rbot_valid_t"][:, None, :],
                    top[m1:][jnp.clip(meta["rbot_gather_t"], 0, nbot - 1)][
                        :, None, :
                    ],
                    jnp.zeros((), dt),
                )  # [rbot_max, 1, S]
        with jax.named_scope("boundary_qt"):
            w2o = _batched_wy_soa(Yb, Tb, w, True, out_rows=2 * o)
            ybot = chain_seq.apply_qt(w2o[:, 0, :].T.reshape(nbot2))
        with jax.named_scope("boundary_backsub"):
            x2 = banded_solve_r(
                chain_r, meta["cols_d"], meta["emit_d"], meta["ncols_d"],
                ybot[:m2],
                max_emit=ckw["max_emit"], max_cols=ckw["max_cols"], n=m2,
            )
        with jax.named_scope("interior_rhs"):
            x2pad = jnp.concatenate(
                [jnp.zeros((o,), dt), x2, jnp.zeros((o,), dt)]
            )
            contrib = highest_precision(jnp.einsum)(
                "sjn,sj->sn", j2_top, x2pad[meta["x2_idx"]]
            )
            if col_runs:
                # interior rhs per segment straight off the apply output:
                # top[:m1] is the concatenation of out2[s, :nloc[s]] runs,
                # and col_gather windows are exactly those runs
                rhs_seg = out2[:, :nloc_max] - contrib  # [S, nloc_max]
                ypad = jnp.where(
                    col_valid,
                    jnp.concatenate(
                        [rhs_seg, jnp.zeros((S, mc), dt)], axis=1
                    ),
                    jnp.zeros((), dt),
                )
            else:
                idx_top = jnp.where(
                    col_valid[:, :nloc_max], col_gather[:, :nloc_max], m1
                )
                rhs1 = top[:m1] - jnp.zeros((m1,), dt).at[idx_top].add(
                    contrib, mode="drop"
                )
                ypad = jnp.where(
                    col_valid, rhs1[col_gather], jnp.zeros((), dt)
                )
        with jax.named_scope("interior_backsub"):
            if bsu:
                xs = _interior_backsub_split(
                    ypad, r_panels, meta, max_emit, mc, bs_nuni,
                    bss=bss, bs_gen=bsg,
                )
            else:
                xs = jax.vmap(
                    lambda xp, yp, rp, cs, er, nc, act: _banded_solve_chunk(
                        xp, yp, rp, cs, er, nc, act, max_emit=max_emit, max_cols=mc
                    )
                )(
                    jnp.zeros_like(ypad), ypad, r_panels, meta["starts"],
                    meta["emit2d"], meta["ncols_loc_d"], meta["active_d"],
                )
        idx = jnp.where(col_valid, col_gather, m1)
        x1 = jnp.zeros((m1,), dt).at[idx].set(xs, mode="drop")
        z = jnp.concatenate([x1, x2])
        return z[meta["gather_cols"]] if has_perm else z

    self._solve_fn = sol
    return sol

def build_solve_mat_fn(self):
    """Fused least-squares solve for a [m, k] RHS (k ≤ 16), ONE compiled
    dispatch per (plan, k) — the protocol default (eager apply_qt +
    vmapped solve_r + gather) issues a dispatch round trip per primitive.

    Same pipeline as the vector program in :meth:`_get_solve_fn`, with the
    lane-major work buffers widened from k=1 to k columns and the two
    back-substitutions vmapped over the RHS axis."""
    if getattr(self, "_solve_mat_fn", None) is not None:
        return self._solve_mat_fn
    from .banded_blocked import banded_solve_r

    self._get_solve_fn()  # builds + caches self._sol_meta
    m1, m2, o = self._m1, self._m2, self._overlap
    S, mc, nloc_max = self.S, self._max_cols, self._nloc_max
    ckw = dict(self._chain_kw)
    h1 = self._kw["max_carry"]
    nrows_tot, max_emit = self._nrows, self._max_emit
    has_perm = not self._cols_perm.is_identity()
    nbot, nbot2 = self._nbot, self._nbot2
    p2u = self._p2_uniform
    nuni = self._p2_nuni
    p2s = getattr(self, "_p2_static", None) if p2u else None
    p2g = getattr(self, "_p2_gen_static", None) if p2u else None
    bsu = p2u and self._bs_uniform
    bs_nuni = self._bs_nuni if bsu else 0
    bss = getattr(self, "_bs_static", None) if bsu else None
    bsg = getattr(self, "_bs_gen_static", None) if bsu else None
    seg_contig = self._seg_contig
    col_runs = self._col_runs
    S_ = self.S
    R_seg, rbm = self._max_seg_rows, self._rbot_max

    @jax.jit
    def sol_mat(Yws, Ts, Yb, Tb, chain_seq, chain_r, j2_top, r_panels, b2, meta):
        dt = b2.dtype
        k = b2.shape[1]
        Yws = jnp.moveaxis(Yws, -1, 0)
        Ts = jnp.moveaxis(Ts, -1, 0)
        r_panels = jnp.moveaxis(r_panels, -1, 0)
        seg_gather, seg_valid = meta["seg_gather"], meta["seg_valid"]
        col_gather, col_valid = meta["col_gather"], meta["col_valid"]
        if seg_contig:
            vt = jnp.moveaxis(
                jnp.pad(
                    b2, ((0, S_ * R_seg - nrows_tot), (0, 0))
                ).reshape(S_, R_seg, k),
                1, 2,
            )  # [S, k, R]
        else:
            vt = jnp.where(
                seg_valid[:, None, :],
                jnp.moveaxis(
                    b2[jnp.clip(seg_gather, 0, nrows_tot - 1)], 1, 2
                ),
                jnp.zeros((), dt),
            )  # [S, k, R]
        out = (
            _apply_cols_split(Yws, Ts, meta, vt, h1, True, nuni, p2s, p2g)
            if p2u
            else _segment_apply_cols(
                Yws, Ts, meta["starts"], meta["rows2d"], meta["carry2d"],
                vt, h1, True,
            )
        )
        if col_runs:
            outp = jnp.concatenate(
                [out, jnp.zeros((S_, k, rbm), dt)], axis=2
            )
            wrows = jax.vmap(
                lambda rows, st: jax.lax.dynamic_slice(
                    rows, (jnp.zeros((), st.dtype), st), (k, rbm)
                )
            )(outp, meta["bot_starts"])  # [S, k, rbm]
            wrows = jnp.where(
                meta["rbot_valid"][:, None, :], wrows, jnp.zeros((), dt)
            )
            w = jnp.transpose(wrows, (2, 1, 0))  # [rbot_max, k, S]
        else:
            scat = jnp.zeros((nrows_tot, k), dt)
            scat = scat.at[seg_gather.reshape(-1)].set(
                jnp.moveaxis(out, 1, 2).reshape(-1, k), mode="drop"
            )
            top = scat[meta["row_order"]]
            w = jnp.where(
                meta["rbot_valid_t"][:, None, :],
                jnp.moveaxis(
                    top[m1:][jnp.clip(meta["rbot_gather_t"], 0, nbot - 1)],
                    1, 2,
                ),
                jnp.zeros((), dt),
            )  # [rbot_max, k, S]
        w2o = _batched_wy_soa(Yb, Tb, w, True, out_rows=2 * o)
        ybot = jnp.moveaxis(w2o, 2, 0).reshape(nbot2, k)
        ybot = chain_seq.apply_qt(ybot)
        x2 = jax.vmap(
            lambda y: banded_solve_r(
                chain_r, meta["cols_d"], meta["emit_d"], meta["ncols_d"],
                y, max_emit=ckw["max_emit"], max_cols=ckw["max_cols"], n=m2,
            ),
            in_axes=1, out_axes=1,
        )(ybot[:m2])  # [m2, k]
        x2pad = jnp.concatenate(
            [jnp.zeros((o, k), dt), x2, jnp.zeros((o, k), dt)]
        )
        contrib = highest_precision(jnp.einsum)(
            "sjn,sjk->snk", j2_top, x2pad[meta["x2_idx"]]
        )
        if col_runs:
            rhs_seg = (
                jnp.moveaxis(out[:, :, :nloc_max], 1, 2) - contrib
            )  # [S, nloc_max, k]
            ypad = jnp.where(
                col_valid[..., None],
                jnp.concatenate(
                    [rhs_seg, jnp.zeros((S_, mc, k), dt)], axis=1
                ),
                jnp.zeros((), dt),
            )  # [S, nloc+mc, k]
        else:
            idx_top = jnp.where(
                col_valid[:, :nloc_max], col_gather[:, :nloc_max], m1
            )
            rhs1 = top[:m1] - jnp.zeros((m1, k), dt).at[idx_top].add(
                contrib, mode="drop"
            )
            ypad = jnp.where(
                col_valid[..., None], rhs1[col_gather], jnp.zeros((), dt)
            )  # [S, nloc+mc, k]
        if bsu:
            xs = jax.vmap(
                lambda yp: _interior_backsub_split(
                    yp, r_panels, meta, max_emit, mc, bs_nuni,
                    bss=bss, bs_gen=bsg,
                ),
                in_axes=2, out_axes=2,
            )(ypad)
        else:
            xs = jax.vmap(
                lambda yp: jax.vmap(
                    lambda xp, ypp, rp, cs, er, nc, act: _banded_solve_chunk(
                        xp, ypp, rp, cs, er, nc, act,
                        max_emit=max_emit, max_cols=mc,
                    )
                )(
                    jnp.zeros_like(yp), yp, r_panels, meta["starts"],
                    meta["emit2d"], meta["ncols_loc_d"], meta["active_d"],
                ),
                in_axes=2, out_axes=2,
            )(ypad)
        idx = jnp.where(col_valid, col_gather, m1)
        x1 = jnp.zeros((m1, k), dt).at[idx].set(xs, mode="drop")
        z = jnp.concatenate([x1, x2])
        return z[meta["gather_cols"]] if has_perm else z

    self._solve_mat_fn = sol_mat
    return sol_mat

