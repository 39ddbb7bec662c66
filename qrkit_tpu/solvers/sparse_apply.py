"""Sparse-operand implicit-Q products for the banded family.

Accelerator replacement for the reference's sparse QProduct specializations —
``matrixQ().transpose() * SparseMatrix`` and friends
(/root/reference/src/QRKit/BandedBlockedSparseQR.h:528-585 general QProduct,
:693-700 / :722-729 sparse-operand forms; used by the block-angular
composition's solveRightBlock, BlockAngularSparseQR.h:360-397).

The reference streams the sparse operand through the implicit Q column by
column and prunes exact zeros from the result.  An accelerator re-design has
two extra constraints: every dispatch and host sync costs launch overhead,
and the *positions* of the output nonzeros must be known up front for
the result to stay on device.  So the product is split into

* a **pattern plan** (host, once per operand layout): a conservative-exact
  *structural fill* of ``Qᵀ·S`` derived from the factorization's touch
  geometry (which rows each reflector block mixes), plus gather/scatter maps
  that scatter the operand's value vector into dense fixed-width column chunks
  and gather the planned fill positions back out; and
* a **fused value program** (device, every compute): ONE jitted
  ``lax.map`` over column chunks — scatter values, apply the one-jit Q
  program, gather fill positions — returning flat value vectors for
  caller-selected index sets (e.g. the block-angular R12-top COO that stays
  on device, and the bottom-block CSR values fetched in one transfer).

The structural fill is a superset of the numeric nonzeros (generic values
make it exact; structured values may cancel — those entries are stored as
explicit zeros, matching setFromTriplets-without-prune).  Fill propagation
models each reflector block k as mixing its touch set
``T(k) = [c_k, c_k+split_k) ∪ [r_k, r_k+nr_k)`` (the two segments of
:class:`~qrkit_tpu.ops.compact_wy.TwoSegmentWYSeq`): if the operand column is
nonzero anywhere in ``T(k)`` at application time, all of ``T(k)`` fills.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "banded_structural_fill",
    "segmented_structural_fill",
    "build_fused_sparse_apply",
    "solver_sparse_apply",
]


def _op_triplets(op, row_map=None):
    """(rows, cols) of the operand's stored entries, optionally row-mapped
    (``dest = row_map[src]`` — folds a solver row permutation into the plan
    so per-compute host work stays O(1))."""
    rows = np.repeat(np.arange(op.nrows), np.diff(op.indptr))
    if row_map is not None:
        rows = np.asarray(row_map)[rows]
    return rows, np.asarray(op.indices)


def banded_structural_fill(geom, nb: int, m: int, op, transpose: bool,
                           row_map=None):
    """Structural fill of ``Qᵀ·S`` (``transpose=True``) or ``Q·S`` for a plain
    banded chain (:func:`~qrkit_tpu.solvers.banded_blocked.banded_geometry`).

    Exact per-block trigger propagation, vectorized over operand columns;
    the only conservatism is treating the union of triggered touch sets as
    one contiguous interval when testing later intersections (a superset).
    Returns ``(rows, cols)`` sorted column-major (cols, then rows).
    """
    c = np.asarray(geom["cols"][:nb])
    split = np.asarray(geom["carry_rows"][:nb])
    r = np.asarray(geom["rows"][:nb])
    nr = np.asarray(geom["nrows"][:nb])
    op_r, op_c = _op_triplets(op, row_map)
    m2 = op.ncols

    # nz-hit tables: does column j have an original nonzero inside block i's
    # touch set?  T2 row ranges are pairwise disjoint (banded plans overlap in
    # columns, never rows) -> one searchsorted; T1 ranges overlap by at most
    # max(split), scanned by offset.
    nzhit = np.zeros((nb, m2), dtype=bool)
    if op_r.size:
        pos = np.searchsorted(r, op_r, side="right") - 1
        ok = (pos >= 0) & (op_r < r[np.clip(pos, 0, None)] + nr[np.clip(pos, 0, None)])
        nzhit[pos[ok], op_c[ok]] = True
        max_split = int(split.max()) if nb else 0
        for d in range(max_split):
            pos1 = np.searchsorted(c, op_r - d, side="left")
            # all blocks with c == op_r - d (c may repeat); scan the run
            run = pos1.copy()
            while True:
                ok1 = (run < nb) & (c[np.clip(run, 0, nb - 1)] == op_r - d) & (
                    split[np.clip(run, 0, nb - 1)] > d
                )
                if not ok1.any():
                    break
                nzhit[run[ok1], op_c[ok1]] = True
                run = run + 1

    trig = np.zeros((nb, m2), dtype=bool)
    tmin = np.where(split > 0, np.minimum(c, r), r)
    tmax = np.maximum(c + split, r + nr)
    if transpose:  # forward application order
        hi = np.full(m2, -1, dtype=np.int64)
        started = np.zeros(m2, dtype=bool)
        for i in range(nb):
            t = nzhit[i] | (started & (tmin[i] < hi))
            trig[i] = t
            np.maximum(hi, tmax[i], out=hi, where=t)
            started |= t
    else:  # Q: reverse application order, fill propagates to lower blocks
        lo = np.full(m2, m + 1, dtype=np.int64)
        started = np.zeros(m2, dtype=bool)
        for i in range(nb - 1, -1, -1):
            t = nzhit[i] | (started & (tmax[i] > lo))
            trig[i] = t
            np.minimum(lo, tmin[i], out=lo, where=t)
            started |= t

    ti, tj = np.nonzero(trig)
    parts_r = [op_r]
    parts_c = [op_c]
    for base, cnt in ((c, split), (r, nr)):
        cn = cnt[ti]
        tot = int(cn.sum())
        if tot:
            starts = np.concatenate([[0], np.cumsum(cn[:-1])])
            off = np.arange(tot) - np.repeat(starts, cn)
            parts_r.append(np.repeat(base[ti], cn) + off)
            parts_c.append(np.repeat(tj, cn))
    rows = np.concatenate(parts_r)
    cols = np.concatenate(parts_c)
    keys = np.unique(cols.astype(np.int64) * m + rows)
    return keys % m, keys // m


def segmented_structural_fill(solver, op, transpose: bool, row_map=None):
    """Structural fill of ``Qᵀ·S`` / ``Q·S`` for a
    :class:`~qrkit_tpu.solvers.segmented_banded.SegmentedBandedQR`.

    Segment-granular (conservative): cross-segment mixing happens ONLY
    through the compressed boundary chain, so a column triggers whole
    segments plus a suffix (Qᵀ) or prefix (Q) of the chain coordinates.
    Output coordinates follow the solver's apply ordering: Qᵀ returns
    [per-segment R rows | chain rows | pass-through rows]; Q returns natural
    rows.  Returns ``(rows, cols)`` sorted column-major.
    """
    S, o = solver.S, solver._overlap
    m1, nbot2 = solver._m1, solver._nbot2
    m = solver._nrows
    seg_row0 = np.asarray(solver._seg_row0, dtype=np.int64)
    seg_rows = np.asarray(solver._seg_rows, dtype=np.int64)
    seg_ncols = np.asarray(solver._seg_ncols, dtype=np.int64)
    seg_col0 = np.asarray(solver._seg_col0, dtype=np.int64)  # cum interior cols
    rbot = np.asarray(solver._rbot, dtype=np.int64)
    cum_rest = np.concatenate([[0], np.cumsum(rbot - 2 * o)])
    G = solver._chain_group
    chain_c = np.asarray(solver._chain_geom["cols"], dtype=np.int64)
    op_r, op_c = _op_triplets(op, row_map)
    m2 = op.ncols

    gs = np.zeros((S, m2), dtype=bool)  # triggered segments
    chain_lim = np.full(m2, -1, dtype=np.int64)  # per-column chain step extent
    if transpose:
        if op_r.size:
            s_of = np.clip(
                np.searchsorted(seg_row0, op_r, side="right") - 1, 0, S - 1
            )
            gs[s_of, op_c] = True
            # chain fill: suffix from the group of the first triggered segment
            first = np.full(m2, S, dtype=np.int64)
            np.minimum.at(first, op_c, s_of)
            chain_lim = first  # min triggered segment (S = none)
    else:
        if op_r.size:
            top = op_r < m1
            s_top = np.clip(
                np.searchsorted(seg_col0, op_r, side="right") - 1, 0, S - 1
            )
            gs[s_top[top], op_c[top]] = True
            ch = (op_r >= m1) & (op_r < m1 + nbot2)
            step = (op_r - m1) // (2 * o)
            # last chain group whose touch-min <= max nz chain position
            pmax = np.full(m2, -1, dtype=np.int64)
            np.maximum.at(pmax, op_c[ch], op_r[ch] - m1)
            chain_lim = pmax  # max nz chain position (-1 = none)
            rest = op_r >= m1 + nbot2
            s_rest = np.clip(
                np.searchsorted(cum_rest, op_r - m1 - nbot2, side="right") - 1,
                0, S - 1,
            )
            gs[s_rest[rest], op_c[rest]] = True

    rows_l, cols_l = [op_r], [op_c]
    if transpose:
        # chain suffix per column: groups >= chain_lim//G fill [cols, nbot2)
        has = chain_lim < S
        start = np.where(
            has, chain_c[np.clip(chain_lim // G, 0, len(chain_c) - 1)], nbot2
        )
        cnt = nbot2 - start
        tot = int(cnt.sum())
        if tot:
            st = np.concatenate([[0], np.cumsum(cnt[:-1])])
            off = np.arange(tot) - np.repeat(st, cnt)
            rows_l.append(m1 + np.repeat(start, cnt) + off)
            cols_l.append(np.repeat(np.arange(m2), cnt))
        # triggered segments: top R block + pass-through rows
        si, sj = np.nonzero(gs)
        for base, cnt_s in (
            (seg_col0, seg_ncols),
            (m1 + nbot2 + cum_rest[:-1], rbot - 2 * o),
        ):
            cn = cnt_s[si]
            tot = int(cn.sum())
            if tot:
                st = np.concatenate([[0], np.cumsum(cn[:-1])])
                off = np.arange(tot) - np.repeat(st, cn)
                rows_l.append(np.repeat(base[si], cn) + off)
                cols_l.append(np.repeat(sj, cn))
    else:
        # chain prefix -> segments in groups whose touch-min <= pmax trigger
        ngrp = len(chain_c)
        for j in np.nonzero(chain_lim >= 0)[0]:
            gmax = int(np.searchsorted(chain_c, chain_lim[j], side="right")) - 1
            gs[: min((gmax + 1) * G, S), j] = True
        # output (natural rows): whole spans of triggered segments
        si, sj = np.nonzero(gs)
        cn = seg_rows[si]
        tot = int(cn.sum())
        if tot:
            st = np.concatenate([[0], np.cumsum(cn[:-1])])
            off = np.arange(tot) - np.repeat(st, cn)
            rows_l.append(np.repeat(seg_row0[si], cn) + off)
            cols_l.append(np.repeat(sj, cn))
        # input positions of untriggered segments pass through in OUTPUT
        # coordinates different from input ones only via triggered segments,
        # so the original (op_r, op_c) seed rows are dropped — any nz input
        # position belongs to some segment, which is then triggered
        rows_l, cols_l = rows_l[1:], cols_l[1:]
        if not rows_l:
            rows_l, cols_l = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    keys = np.unique(cols.astype(np.int64) * m + rows)
    return keys % m, keys // m


def _pad_group(order, group_of, T, F, payloads, sentinels):
    """Scatter ``payloads[order]`` into ``[T, F]`` arrays grouped by
    ``group_of[order]`` (already group-sorted), padding with sentinels."""
    cnt = np.bincount(group_of, minlength=T)
    starts = np.concatenate([[0], np.cumsum(cnt[:-1])])
    slot = np.arange(group_of.size) - np.repeat(starts, cnt)
    outs = []
    for p, s in zip(payloads, sentinels):
        a = np.full((T, F), s, dtype=np.int64)
        a[group_of, slot] = p[order] if order is not None else p
        outs.append(a)
    return outs


def build_fused_sparse_apply(
    apply_fn, fill_rows, fill_cols, op, m: int, row_map=None, w: int = 128,
):
    """Build the per-layout plan + ONE jitted chunked program.

    ``apply_fn(factors, meta, M)`` is the solver's traceable [m, w] → [m, w]
    Q/Qᵀ matrix program (all device arrays passed as arguments — a
    closure-captured device array would be baked into the executable).
    Returns a dict with ``run(factors, meta, data, maps, sels)`` →
    tuple of flat value vectors (one per entry of ``sels``), plus the
    canonical (column-major) fill coordinates and index helpers.

    Peak device memory is O(m·w) per chunk (no dense [m, m2] intermediate);
    the chunk loop lives inside the jit (``lax.map``), so a full product is
    one dispatch regardless of the operand width.
    """
    from ..sparse import SparseCSR  # noqa: F401  (type reference)

    m2 = op.ncols
    w = max(1, min(w, m2 if m2 else 1))
    T = max(1, -(-m2 // w))

    # --- input scatter maps (operand values -> dense [m, w] chunks) ---------
    op_r, op_c = _op_triplets(op, row_map)
    chunk_in = op_c // w
    Fin = max(1, int(np.bincount(chunk_in, minlength=T).max()) if op_r.size else 1)
    order_in = np.argsort(chunk_in, kind="stable")
    in_idx, in_rows, in_lcols = _pad_group(
        order_in, chunk_in[order_in], T, Fin,
        (np.arange(op_r.size), op_r, op_c % w),
        (op.nnz, m, 0),  # sentinel row m -> dropped scatter
    )

    # --- output gather maps (fill positions out of each chunk) --------------
    chunk_out = fill_cols // w
    Fout = max(
        1, int(np.bincount(chunk_out, minlength=T).max()) if fill_rows.size else 1
    )
    # fill_rows/cols arrive column-major; stable-sort by chunk keeps that
    # order within each chunk, so flat position of fill entry i is
    # chunk*Fout + slot (recorded in `flat_pos`)
    order_out = np.argsort(chunk_out, kind="stable")
    out_rows, out_lcols = _pad_group(
        order_out, chunk_out[order_out], T, Fout,
        (fill_rows, fill_cols % w), (0, 0),
    )
    cnt = np.bincount(chunk_out, minlength=T)
    starts = np.concatenate([[0], np.cumsum(cnt[:-1])])
    slot = np.arange(fill_rows.size) - np.repeat(starts, cnt)
    flat_pos = np.empty(fill_rows.size, dtype=np.int64)
    flat_pos[order_out] = chunk_out[order_out] * Fout + slot

    def _imap32(a):
        a = np.asarray(a)
        if a.size == 0 or a.max(initial=0) < 2**31 - 1:
            return jnp.asarray(np.ascontiguousarray(a, dtype=np.int32))
        return jnp.asarray(np.ascontiguousarray(a))

    maps = dict(
        in_idx=_imap32(in_idx), in_rows=_imap32(in_rows),
        in_lcols=_imap32(in_lcols), out_rows=_imap32(out_rows),
        out_lcols=_imap32(out_lcols),
    )

    @jax.jit
    def run(factors, meta, data, maps, sels):
        pad = jnp.concatenate([data, jnp.zeros((1,), data.dtype)])

        def body(xs):
            ii, ir, il, orow, ocol = xs
            chunk = (
                jnp.zeros((m, w), data.dtype)
                .at[ir, il]
                .set(pad[ii], mode="drop")
            )
            j2 = apply_fn(factors, meta, chunk)
            return j2[orow, ocol]

        out = jax.lax.map(
            body,
            (maps["in_idx"], maps["in_rows"], maps["in_lcols"],
             maps["out_rows"], maps["out_lcols"]),
        )
        flat = out.reshape(-1)
        return tuple(flat[s] for s in sels)

    return dict(
        run=run, maps=maps, flat_pos=flat_pos,
        fill_rows=fill_rows, fill_cols=fill_cols, w=w, T=T,
    )


def solver_sparse_apply(solver, op, transpose: bool):
    """Shared implementation of the public ``apply_qt_sparse`` /
    ``apply_q_sparse`` on the banded family (the reference's
    ``matrixQ().transpose() * SparseMatrix``, BandedBlockedSparseQR.h:693-700).

    Plan-cached per (direction, operand layout): repeated products on one
    sparsity issue ONE fused dispatch + ONE value fetch.  The result is
    numerically pruned like the reference's setFromTriplets (structural-fill
    entries that evaluate to exact zero are dropped), so nnz matches the
    eager dense path on generic data."""
    from ..sparse import SparseCSR

    cache = getattr(solver, "_sparse_apply_cache", None)
    if cache is None:
        cache = solver._sparse_apply_cache = {}
    key = (transpose, op.pattern_fingerprint(), op.shape)
    ent = cache.get(transpose)
    if ent is None or ent["key"] != key:
        fill_fn, apply_fn = solver._sparse_apply_parts(transpose)
        fr, fc = fill_fn(op, None)
        plan = build_fused_sparse_apply(apply_fn, fr, fc, op, solver.rows)
        order = np.lexsort((fc, fr))  # CSR (row-major) output order
        ent = dict(
            key=key, plan=plan,
            sel=jnp.asarray(plan["flat_pos"][order]),
            rows=fr[order], cols=fc[order],
        )
        cache[transpose] = ent
    dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
    factors, meta = solver._sparse_apply_state()
    (vals,) = ent["plan"]["run"](
        factors, meta, jnp.asarray(np.asarray(op.data, dtype)),
        ent["plan"]["maps"], (ent["sel"],),
    )
    v = np.asarray(vals)
    nz = v != 0.0
    return SparseCSR.from_triplets(
        ent["rows"][nz], ent["cols"][nz], v[nz], (solver.rows, op.ncols)
    )
