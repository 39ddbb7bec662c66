"""Phase-2 segment applies for the segmented banded solver.

The per-segment two-segment Q/Q\u1d40 application machinery in all its gated
variants (general vmapped, shared-scalar uniform, statically unrolled,
streaming, gap-mode streaming) plus the batched compact-WY helpers and the
one-jit whole-matrix Q/Q\u1d40 programs.  Split from segmented_banded.py
(round 4); behavior-identical moves.  The position-based window semantics
(values at work-vector positions, gap rows riding along under zero-Y rows —
reference: SparseBlockYTY.h:101-139, SparseQRUtils.h:44-89) are pinned by
tests/test_segmented_banded.py and tests/test_fuzz_segmented_surfaces.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.compact_wy import TwoSegmentWYSeq
from ..ops.householder import highest_precision

@functools.partial(jax.jit, static_argnames=("h1", "transpose"))
@highest_precision
def _segment_apply_cols(Yws, Ts, s1, s2, split, vt, h1: int, transpose: bool):
    """Per-segment two-segment Q/Qᵀ apply on LANE-MAJOR operands [S, k, rows].

    Same math as :func:`_segment_apply`, but the operand is stored transposed
    so the long row axis is minor: every per-step dynamic slice/update
    then moves contiguous runs of a [k, seg_rows] operand (a 2o-column slab,
    or k=1 for a solve vector).  Used on the factorize (Qᵀ·A_B) and fused-solve paths; general
    matrix applies keep the row-major form.
    """
    S, k, R = vt.shape
    A = Yws.shape[2]
    jA = jax.lax.broadcasted_iota(jnp.int32, (A,), 0)
    j1 = jax.lax.broadcasted_iota(jnp.int32, (h1,), 0)

    def one(Y, T, a1, a2, sp, v):
        vp = jnp.concatenate([v, jnp.zeros((k, h1 + A), v.dtype)], axis=1)

        def body(carry, blk):
            Yk, Tk, s1v, s2v, spv = blk
            zero = jnp.zeros((), s1v.dtype)
            w1 = jax.lax.dynamic_slice(carry, (zero, s1v), (k, h1))
            w2 = jax.lax.dynamic_slice(carry, (zero, s2v), (k, A))
            wg = jnp.where(
                (jA < spv)[None, :],
                w1[:, jnp.clip(jA, 0, h1 - 1)],
                w2[:, jnp.clip(jA - spv, 0, A - 1)],
            )
            # (Y (T' (Yᵀ w)))ᵀ = wᵀ Y T'ᵀ Yᵀ;  Qᵀ uses T' = Tᵀ, Q uses T
            Tt = Tk if transpose else Tk.T
            wg = wg + ((wg @ Yk) @ Tt) @ Yk.T
            w1o = jnp.where((j1 < spv)[None, :], wg[:, jnp.clip(j1, 0, A - 1)], w1)
            w2o = jnp.where(
                (jA + spv < A)[None, :], wg[:, jnp.clip(jA + spv, 0, A - 1)], w2
            )
            carry = jax.lax.dynamic_update_slice(carry, w1o, (zero, s1v))
            carry = jax.lax.dynamic_update_slice(carry, w2o, (zero, s2v))
            return carry, None

        out, _ = jax.lax.scan(
            body, vp, (Y, T, a1, a2, sp), reverse=not transpose
        )
        return out[:, :R]

    return jax.vmap(one)(Yws, Ts, s1, s2, split, vt)


@functools.partial(jax.jit, static_argnames=("h1", "transpose"))
@highest_precision
def _segment_apply_cols_shared(Yws, Ts, s1u, s2u, spu, vt, h1: int, transpose: bool):
    """Uniform-geometry batch form of :func:`_segment_apply_cols`.

    On a uniform chain every segment after the first shares ONE window-scalar
    sequence (s1/s2/split per chain step — verified by the caller's
    ``_p2_uniform`` gate), so each step's windows can be cut with a single
    batch ``dynamic_slice`` over all segments.  The vmapped per-segment form
    lowers those slices to gathers over the whole work buffer.  Segments whose
    trailing steps are inactive (the padded tail) are exact no-ops under
    shared scalars: with ``Y = T = 0`` the update vanishes and the
    recomposed windows write back exactly the values they gathered.
    """
    S, k, R = vt.shape
    A = Yws.shape[2]
    jA = jax.lax.broadcasted_iota(jnp.int32, (A,), 0)
    j1 = jax.lax.broadcasted_iota(jnp.int32, (h1,), 0)
    vp = jnp.concatenate([vt, jnp.zeros((S, k, h1 + A), vt.dtype)], axis=2)
    Yl = jnp.moveaxis(Yws, 0, 1)  # [L, S, A, mc]
    Tl = jnp.moveaxis(Ts, 0, 1)

    def body(carry, blk):
        Yk, Tk, s1v, s2v, spv = blk
        zero = jnp.zeros((), s1v.dtype)
        w1 = jax.lax.dynamic_slice(carry, (zero, zero, s1v), (S, k, h1))
        w2 = jax.lax.dynamic_slice(carry, (zero, zero, s2v), (S, k, A))
        # composed-window tail in ONE slice: position s2v-spv+j equals
        # w2[j-spv] exactly where j >= spv (the gate asserts spv <= s2v)
        wt = jax.lax.dynamic_slice(carry, (zero, zero, s2v - spv), (S, k, A))
        wg = jnp.where(
            (jA < spv)[None, None, :], w1[..., jnp.clip(jA, 0, h1 - 1)], wt
        )
        Tt = Tk if transpose else jnp.swapaxes(Tk, 1, 2)
        wg = wg + ((wg @ Yk) @ Tt) @ jnp.swapaxes(Yk, 1, 2)
        w1o = jnp.where(
            (j1 < spv)[None, None, :], wg[..., jnp.clip(j1, 0, A - 1)], w1
        )
        wgp = jnp.concatenate([wg, jnp.zeros((S, k, h1), wg.dtype)], axis=2)
        w2o = jnp.where(
            (jA + spv < A)[None, None, :],
            jax.lax.dynamic_slice(wgp, (zero, zero, spv), (S, k, A)),
            w2,
        )
        carry = jax.lax.dynamic_update_slice(carry, w1o, (zero, zero, s1v))
        carry = jax.lax.dynamic_update_slice(carry, w2o, (zero, zero, s2v))
        return carry, None

    out, _ = jax.lax.scan(body, vp, (Yl, Tl, s1u, s2u, spu), reverse=not transpose)
    return out[:, :, :R]


@highest_precision
def _segment_apply_cols_shared_static(Yws, Ts, s1t, s2t, spt, vt, h1, transpose):
    """Statically-unrolled form of :func:`_segment_apply_cols_shared`.

    The shared window scalars are PLAN data (host-known integers), so every
    per-step window cut and write-back can be a static ``lax.slice`` /
    ``dynamic_update_slice`` and the masked two-segment recomposition
    collapses to two static slices + one concat.  The ``lax.scan`` form
    re-materializes the whole [S, k, R] work buffer every step — the carry
    is read by three dynamic slices before being updated, which defeats
    in-place aliasing, so it moves far more than its window traffic;
    unrolled with static offsets XLA updates the buffer in place.  Inactive trailing
    steps of padded segments are exact no-ops (``Y = T = 0`` makes the
    update vanish and the write-back restores the gathered values).
    """
    S, k, R = vt.shape
    A = Yws.shape[2]
    L = Yws.shape[1]
    carry = jnp.concatenate([vt, jnp.zeros((S, k, h1 + A), vt.dtype)], axis=2)
    order = range(L) if transpose else reversed(range(L))
    for l in order:
        s1, s2, sp = int(s1t[l]), int(s2t[l]), int(spt[l])
        Yk = Yws[:, l]  # [S, A, mc]
        Tk = Ts[:, l]
        Tt = Tk if transpose else jnp.swapaxes(Tk, 1, 2)
        tw = A - sp
        parts = []
        if sp:
            parts.append(jax.lax.slice(carry, (0, 0, s1), (S, k, s1 + sp)))
        if tw:
            parts.append(jax.lax.slice(carry, (0, 0, s2), (S, k, s2 + tw)))
        wg = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=2)
        wg = wg + ((wg @ Yk) @ Tt) @ jnp.swapaxes(Yk, 1, 2)
        if sp:
            carry = jax.lax.dynamic_update_slice(carry, wg[:, :, :sp], (0, 0, s1))
        if tw:
            carry = jax.lax.dynamic_update_slice(carry, wg[:, :, sp:], (0, 0, s2))
    return carry[:, :, :R]


def _p2_stream_plan(s1t, s2t, spt, A: int, L: int, R: int):
    """Static analysis enabling the rolling-window phase-2 apply (Qᵀ order).

    The window at step ``l`` spans ``[s1_l, s2_l + (A - sp_l))`` of the
    work vector: lanes left of ``s1_l`` are FINAL (no later step reads or
    writes them — heads march right), lanes right of the previous window
    edge are PRISTINE operand values (writes always land inside the
    window).  Valid iff ``s1`` is nondecreasing and each step's head
    ``[s1, s1+sp)`` precedes its tail ``[s2, s2+A-sp)`` disjointly.

    Two live-window shapes are planned here (``None`` when neither holds):

    ``mono`` — one contiguous window ``[s1_l, s2_l + tw_l)``.  On *gapped*
    chains (block rows ≫ column step — the head advances ``emit`` lanes per
    step while the tail advances a whole block height) that window grows
    O(L·block_rows) wide and the per-step re-concat costs O(L²) traffic.

    ``gap`` — two regions split at ``h = max_l(s1_l + sp_l)``, the furthest
    lane any head window ever reaches.  Region A ``[0, h)`` rides in a small
    rolling buffer; each step's tail lanes ≥ ``h`` are read PRISTINE,
    transformed once, and emitted immediately (valid iff those above-``h``
    tail spans are mutually disjoint and nondecreasing — no later step reads
    or writes an emitted lane; heads can't, they stop at ``h``).  Live width
    falls from ~1150 to ~170 lanes on the config-3 chain.

    Returns a dict ``{"mode": "mono"|"gap", "h": int}`` (truthy) or ``None``.
    """
    for l in range(L):
        s1, s2, sp = int(s1t[l]), int(s2t[l]), int(spt[l])
        if sp and s2 < s1 + sp:
            return None
        if l and s1 < int(s1t[l - 1]):
            return None
        if s2 < s1:
            return None
    h = 0
    live_mono = 0
    for l in range(L):
        s1, s2, sp = int(s1t[l]), int(s2t[l]), int(spt[l])
        h = max(h, s1 + sp)
        live_mono = max(live_mono, s2 + (A - sp) - s1)
    gap_ok = True
    rb = h
    for l in range(L):
        s2, sp = int(s2t[l]), int(spt[l])
        tw = A - sp
        if s2 + tw > h:
            if max(s2, h) < rb:
                gap_ok = False
                break
            rb = s2 + tw
    live_gap = h + A
    if gap_ok and 2 * live_gap < live_mono:
        return {"mode": "gap", "h": h}
    return {"mode": "mono", "h": h}


@highest_precision
def _segment_apply_cols_stream(Yws, Ts, s1t, s2t, spt, vt, transpose):
    """Rolling-window form of :func:`_segment_apply_cols_shared_static`
    (Qᵀ order only).

    The unrolled-static form still updates a [S, k, R] HBM buffer twice per
    step, and in the factorize pipeline XLA fails to alias those updates —
    each ``dynamic_update_slice`` becomes a whole-buffer copy.  Here the work vector is
    never held as an updatable buffer at all: a live window VALUE spanning
    ``[s1_l, s2_l+A-sp_l)`` rolls right over the operand — finalized lanes
    are emitted on the left, pristine operand lanes ingested on the right
    (:func:`_p2_stream_plan` checks the geometry) — and the output is
    assembled with ONE static concat of the emitted chunks, the final
    window, and the untouched operand tail."""
    S, k, R = vt.shape
    A = Yws.shape[2]
    L = Yws.shape[1]
    assert transpose, "streaming form is Qᵀ-order only"
    dt = vt.dtype

    def pristine(lo, hi):
        hi_r = max(min(hi, R), lo)
        parts = []
        if hi_r > lo:
            parts.append(jax.lax.slice(vt, (0, 0, lo), (S, k, hi_r)))
        if hi > hi_r:
            parts.append(jnp.zeros((S, k, hi - hi_r), dt))
        return parts

    plan = _p2_stream_plan(s1t, s2t, spt, A, L, R)
    assert plan is not None, "caller must gate on _p2_stream_plan"
    if plan["mode"] == "gap":
        return _segment_apply_cols_stream_gap(
            Yws, Ts, s1t, s2t, spt, vt, plan["h"], pristine
        )

    emitted = []
    W = jnp.zeros((S, k, 0), dt)
    w0, w1 = 0, 0  # current window coverage [w0, w1)

    for l in range(L):
        s1, s2, sp = int(s1t[l]), int(s2t[l]), int(spt[l])
        tw = A - sp
        if s1 > w0:  # lanes left of s1 are final: emit
            d = min(s1, w1) - w0
            if d > 0:
                emitted.append(W[:, :, :d])
                W = W[:, :, d:]
            if s1 > w1:  # window detached: flush pristine gap
                emitted.extend(pristine(max(w1, w0), s1))
                w1 = s1
            w0 = s1
        end = s2 + tw
        if end > w1:  # ingest pristine lanes on the right
            W = jnp.concatenate([W] + pristine(w1, end), axis=2)
            w1 = end
        Yk = Yws[:, l]
        Tk = Ts[:, l]
        parts = []
        if sp:
            parts.append(W[:, :, : sp])  # head sits at the window start
        if tw:
            parts.append(W[:, :, s2 - w0 : s2 - w0 + tw])
        wg = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=2)
        wg = wg + ((wg @ Yk) @ Tk) @ jnp.swapaxes(Yk, 1, 2)
        segs = []
        if sp:
            segs.append(wg[:, :, :sp])
            segs.append(W[:, :, sp : s2 - w0])
        else:
            segs.append(W[:, :, : s2 - w0])
        if tw:
            segs.append(wg[:, :, sp:])
            segs.append(W[:, :, s2 - w0 + tw :])
        W = jnp.concatenate(segs, axis=2)
    pieces = emitted + [W] + pristine(w1, max(R, w1))
    out = jnp.concatenate(pieces, axis=2)
    return out[:, :, :R]


def _segment_apply_cols_stream_gap(Yws, Ts, s1t, s2t, spt, vt, h, pristine):
    """Two-region form of :func:`_segment_apply_cols_stream` for GAPPED
    chains (see ``_p2_stream_plan``'s ``gap`` mode for the geometry proof).

    Region A ``[0, h)`` — every lane any head window ever touches — is
    pre-ingested into a small rolling buffer ``W`` whose left edge emits as
    heads march right; each step's tail lanes ≥ ``h`` are sliced PRISTINE
    from the operand, transformed with the step's WY factor, and emitted
    immediately (they are final: above-``h`` tail spans are disjoint and no
    head reaches them).  Per-step traffic is O(h + A) lanes instead of the
    mono window's O(step · block_rows)."""
    S, k, R = vt.shape
    A = Yws.shape[2]
    L = Yws.shape[1]
    em_l = []  # finalized pieces covering [0, w0)
    em_r = []  # finalized pieces covering [h, rb)
    parts0 = pristine(0, h)
    W = parts0[0] if len(parts0) == 1 else jnp.concatenate(parts0, axis=2)
    w0, rb = 0, h
    for l in range(L):
        s1, s2, sp = int(s1t[l]), int(s2t[l]), int(spt[l])
        tw = A - sp
        if s1 > w0:  # lanes left of s1 are final: emit from the A-buffer
            em_l.append(W[:, :, : s1 - w0])
            W = W[:, :, s1 - w0 :]
            w0 = s1
        below = max(0, min(s2 + tw, h) - s2)  # tail lanes inside region A
        above = tw - below
        parts = []
        if sp:
            parts.append(W[:, :, :sp])  # head sits at the window start
        if below:
            parts.append(W[:, :, s2 - w0 : s2 - w0 + below])
        if above:
            a_lo = max(s2, h)
            if a_lo > rb:  # pristine gap between emitted tails: flush
                em_r.extend(pristine(rb, a_lo))
                rb = a_lo
            parts.extend(pristine(a_lo, s2 + tw))
        wg = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=2)
        Yk = Yws[:, l]
        Tk = Ts[:, l]
        wg = wg + ((wg @ Yk) @ Tk) @ jnp.swapaxes(Yk, 1, 2)
        segs = []
        if sp:
            segs.append(wg[:, :, :sp])
        if below:
            segs.append(W[:, :, sp : s2 - w0])
            segs.append(wg[:, :, sp : sp + below])
            segs.append(W[:, :, s2 - w0 + below :])
        else:
            segs.append(W[:, :, sp:])
        W = segs[0] if len(segs) == 1 else jnp.concatenate(segs, axis=2)
        if above:
            em_r.append(wg[:, :, sp + below :])
            rb = s2 + tw
    pieces = em_l + [W] + em_r + pristine(rb, max(R, rb))
    out = jnp.concatenate(pieces, axis=2)
    return out[:, :, :R]


def _apply_cols_split(
    Yws, Ts, meta, vt, h1: int, transpose: bool, nuni: int, p2s=None,
    gen_static=None,
):
    """Phase-2 lane-major apply on uniform plans: segments ``1..1+nuni``
    (the maximal uniform run found by the plan-time gate) run the
    shared-scalar batch path; segment 0 (distinct local column starts — it
    keeps its leading overlap) and any irregular tail segments (a final
    chain block without trailing overlap changes the last segment's
    geometry) run the general per-segment path.  ``p2s`` carries the shared
    scalars as host tuples when available, selecting the unrolled-static
    uniform path; ``gen_static`` carries each general segment's own scalar
    tuples (trimmed to its active steps) so those 2-3 segments ALSO unroll
    statically — the vmapped 32-step scan over just the irregular segments
    is pure scan-step latency."""
    S = vt.shape[0]
    e = 1 + nuni
    gi = np.array([0] + list(range(e, S)))
    if transpose and gen_static is not None and len(gen_static) == len(gi):
        # batch-gather the few irregular segments' operands ONCE, then slice
        # the small gathered arrays per segment: per-step slices that remain
        # views of the full factor arrays re-pay the producer transpose on
        # every step
        Yg, Tg, vg = Yws[gi], Ts[gi], vt[gi]
        outs_g = []
        for k in range(len(gi)):
            s1t, s2t, spt = gen_static[k]
            n = len(s1t)
            outs_g.append(
                _segment_apply_cols_stream(
                    Yg[k : k + 1, :n], Tg[k : k + 1, :n], s1t, s2t, spt,
                    vg[k : k + 1], transpose,
                )
            )
        out_g = jnp.concatenate(outs_g, axis=0)
    else:
        out_g = _segment_apply_cols(
            Yws[gi], Ts[gi], meta["starts"][gi], meta["rows2d"][gi],
            meta["carry2d"][gi], vt[gi], h1, transpose,
        )
    if p2s is not None:
        stream = p2s[3] if len(p2s) > 3 else None
        if transpose and stream is not None:
            out_u = _segment_apply_cols_stream(
                Yws[1:e], Ts[1:e], p2s[0], p2s[1], p2s[2], vt[1:e], transpose
            )
        else:
            out_u = _segment_apply_cols_shared_static(
                Yws[1:e], Ts[1:e], p2s[0], p2s[1], p2s[2], vt[1:e], h1,
                transpose,
            )
    else:
        out_u = _segment_apply_cols_shared(
            Yws[1:e], Ts[1:e], meta["s1u"], meta["s2u"], meta["spu"],
            vt[1:e], h1, transpose,
        )
    return jnp.concatenate([out_g[:1], out_u, out_g[1:]], axis=0)



@functools.partial(jax.jit, static_argnames=("transpose",))
@highest_precision
def _batched_wy_cols(Y, T, Mt, transpose: bool):
    """Batched compact-WY apply on lane-major operands Mt [S, k, rows]."""
    Tt = T if transpose else jnp.swapaxes(T, 1, 2)
    return Mt + ((Mt @ Y) @ Tt) @ jnp.swapaxes(Y, 1, 2)


@functools.partial(jax.jit, static_argnames=("transpose", "out_rows"))
@highest_precision
def _batched_wy_soa(Y_soa, T_aos, w_soa, transpose: bool, out_rows=None):
    """Batched compact-WY apply with the batch axis in LANES.

    ``Y_soa`` [m, n, S] (the CAQR factors as stored), ``T_aos`` [S, n, n]
    (small, stored AoS), ``w_soa`` [m, k, S].  Computes
    ``w + Y (T or Tᵀ) (Yᵀ w)`` per lane-batch entry; with ``out_rows=r``
    only the first r output rows are formed (the fused solve feeds just the
    2o chain-space rows onward, so the m−2o pass-through rows of Y need only
    be READ for Yᵀw, never written back).  All contractions are
    broadcast-multiply + axis-sum — elementwise over the batch axis, no
    dot_general relayout of the SoA operand.
    """
    T_soa = jnp.transpose(T_aos, (1, 2, 0))  # [n, n, S]
    u = jnp.sum(Y_soa[:, :, None, :] * w_soa[:, None, :, :], axis=0)  # [n,k,S]
    Tm = jnp.swapaxes(T_soa, 0, 1) if transpose else T_soa
    z = jnp.sum(Tm[:, :, None, :] * u[None, :, :, :], axis=1)  # [n,k,S]
    Yr = Y_soa if out_rows is None else Y_soa[:out_rows]
    wr = w_soa if out_rows is None else w_soa[:out_rows]
    return wr + jnp.sum(Yr[:, :, None, :] * z[None, :, :, :], axis=1)


@functools.partial(jax.jit, static_argnames=("h1", "transpose", "vec"))
@highest_precision
def _segment_apply(Yws, Ts, s1, s2, split, v_seg, h1: int, transpose: bool, vec: bool):
    """Per-segment two-segment compact-WY application, vmapped over segments.

    v_seg: [S, seg_rows(+pad)] or [S, seg_rows, k]."""
    if vec:
        v_seg = v_seg[..., None]
    S, rows, k = v_seg.shape

    def one(Y, T, a1, a2, sp, v):
        seq = TwoSegmentWYSeq(Y, T, a1, a2, sp, h1=h1, m=rows)
        return seq._apply(v, transpose)

    out = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0))(Yws, Ts, s1, s2, split, v_seg)
    return out[..., 0] if vec else out


@highest_precision
def _seg_qt_program(
    factors, meta, v2, *, S, R, nrows, m1, nbot, nbot2, rbot_max, o, h1
):
    """Whole Qᵀ·M as ONE traced program (the general-matrix QProduct of
    BandedBlockedSparseQR.h:552-585, segmented form).

    Phase-1 per-segment Qᵀ (block-diagonal over segments), reorder R-space
    rows first, then the compressed boundary reduction (blockdiag Qbᵀ +
    chain Qᵀ) on the bottom region.  ``factors``/``meta`` carry every device
    array as jit arguments; the statics are plan integers."""
    Yws = jnp.moveaxis(factors["Yws"], -1, 0)
    Ts = jnp.moveaxis(factors["Ts"], -1, 0)
    k = v2.shape[1]
    seg_gather, seg_valid = meta["seg_gather"], meta["seg_valid"]
    vs = jnp.where(
        seg_valid[..., None],
        v2[jnp.clip(seg_gather, 0, nrows - 1)],
        jnp.zeros((), v2.dtype),
    )  # [S, R, k]
    out = _segment_apply(
        Yws, Ts, meta["starts"], meta["rows2d"], meta["carry2d"],
        vs, h1, True, False,
    )
    flat = out.reshape(S * R, k)
    scatter = jnp.zeros((nrows, k), v2.dtype)
    scatter = scatter.at[seg_gather.reshape(-1)].set(flat, mode="drop")
    top = scatter[meta["row_order"]]
    # bottom region, SoA throughout ([rbot, k, S], matching the Yb store):
    # transposing Yb to AoS would add a relayout pass
    vb = top[m1:]
    w = jnp.where(
        meta["rbot_valid_t"][:, None, :],
        jnp.moveaxis(vb[jnp.clip(meta["rbot_gather_t"], 0, nbot - 1)], 1, 2),
        jnp.zeros((), v2.dtype),
    )  # [rbot_max, k, S]
    w = _batched_wy_soa(factors["Yb"], factors["Tb"], w, True)
    z = factors["chain_seq"].apply_qt(
        jnp.moveaxis(w[: 2 * o], 2, 0).reshape(nbot2, k)
    )
    bout = jnp.zeros((nbot, k), v2.dtype).at[:nbot2].set(z)
    if rbot_max > 2 * o:
        bout = bout.at[meta["rest_pos"].reshape(-1)].set(
            jnp.moveaxis(w[2 * o :], 2, 0).reshape(-1, k), mode="drop"
        )
    return jnp.concatenate([top[:m1], bout], axis=0)


@highest_precision
def _seg_q_program(
    factors, meta, v2, *, S, R, nrows, m1, nbot, nbot2, rbot_max, o, h1
):
    """Inverse of :func:`_seg_qt_program`: chain Q + blockdiag Qb on the
    bottom region, then the per-segment Q in natural row order."""
    k = v2.shape[1]
    vb = v2[m1:]
    z = factors["chain_seq"].apply_q(vb[:nbot2]).reshape(S, 2 * o, k)
    if rbot_max > 2 * o:
        rest = jnp.where(
            (meta["rest_pos"] < nbot)[..., None],
            vb[jnp.clip(meta["rest_pos"], 0, nbot - 1)],
            jnp.zeros((), v2.dtype),
        )
        w = jnp.concatenate([z, rest], axis=1)
    else:
        w = z
    w = _batched_wy_soa(factors["Yb"], factors["Tb"], jnp.moveaxis(w, 0, 2), False)
    bout = jnp.zeros((nbot, k), v2.dtype)
    bout = bout.at[meta["rbot_gather"].reshape(-1)].set(
        jnp.moveaxis(w, 2, 0).reshape(-1, k), mode="drop"
    )
    full = jnp.concatenate([v2[:m1], bout], axis=0)
    nat = full[meta["row_order_inv"]]
    vs = jnp.where(
        meta["seg_valid"][..., None],
        nat[jnp.clip(meta["seg_gather"], 0, nrows - 1)],
        jnp.zeros((), v2.dtype),
    )
    out = _segment_apply(
        jnp.moveaxis(factors["Yws"], -1, 0), jnp.moveaxis(factors["Ts"], -1, 0),
        meta["starts"], meta["rows2d"], meta["carry2d"],
        vs, h1, False, False,
    )
    flat = out.reshape(S * R, k)
    scatter = jnp.zeros((nrows, k), v2.dtype)
    return scatter.at[meta["seg_gather"].reshape(-1)].set(flat, mode="drop")


