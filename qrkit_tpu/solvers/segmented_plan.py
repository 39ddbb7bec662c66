"""Plan-time preparation for the segmented banded solver.

Host-side, once-per-plan machinery: segment-geometry derivation, gather-map
construction, the phase-2 uniformity gates, the Pallas kernel gates, and the
gather-free panel-extraction detection.  Split from segmented_banded.py
(round 4); functions keep their `self` receiver (the SegmentedBandedQR
instance) so the move is behavior-identical.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..analysis import from_block_banded_pattern
from ..ops.compact_wy import TwoSegmentWYSeq
from ..sparse import Permutation
from .banded_blocked import banded_geometry
from .segmented_apply import _p2_stream_plan


def _imap(a) -> jnp.ndarray:
    """Device index map in int32 when every index fits (see segmented_banded)."""
    a = np.asarray(a)
    if a.size == 0 or (a.min() >= -(2**31) and a.max() < 2**31 - 1):
        return jnp.asarray(np.ascontiguousarray(a, dtype=np.int32))
    return jnp.asarray(np.ascontiguousarray(a))


def segment_plan(self):
    """Segmentation bookkeeping for an installed ``self.plan``."""
    self._nrows, self._ncols = self.plan.nrows, self.plan.ncols
    p = self.plan
    nb = p.num_blocks
    if nb < 2 * self.L:
        raise ValueError("chain too short for segmentation; use BandedBlockedQR")
    b0 = p.blocks[0]
    body = p.blocks[1:-1]
    if not all(b.nrows == b0.nrows and b.ncols == b0.ncols for b in body):
        raise ValueError("non-uniform plan; use BandedBlockedQR")
    g = banded_geometry(p)
    step = int(g["col_inc"][0])
    if not np.all(g["col_inc"][:-1] == step):
        raise ValueError("non-uniform column step; use BandedBlockedQR")
    self._overlap = b0.ncols - step
    if self._overlap <= 0:
        raise ValueError("no overlap: use BlockDiagonalQR for this structure")
    if self._overlap > step:
        raise ValueError("overlap exceeds column step; use BandedBlockedQR")
    self.geom = g
    # invalidate lazy per-plan caches before rebuilding
    for attr in (
        "_seg_gather", "_col_gather", "_fac_fn", "_solve_fn",
        "_apply_fns", "_solve_mat_fn",
    ):
        if hasattr(self, attr):
            delattr(self, attr)
    self._panel_gmap = None
    self._slab_gmap = None
    self._panel_fast = None
    self._slab_fast = None
    self._prepare_segmentation()
    self._analysis_ok = True
    return self

# --- factorization --------------------------------------------------------------
def prepare_segmentation(self):
    """Pattern-only segmentation bookkeeping, run ONCE per plan.

    Everything here (segment spans, per-segment local plans/geometry,
    panel descriptor list, device-resident metadata, the P_split column
    permutation) depends only on the sparsity plan — recomputing it every
    factorize made repeated computes host-bound (the LM pattern:
    analyzePattern once, factorize per iteration)."""
    p, g = self.plan, self.geom
    nb, L = p.num_blocks, self.L
    o = self._overlap
    S = -(-nb // L)
    self.S = S
    rows_, cols_, nrows_, ncols_ = p.as_arrays()

    # --- segment row/column spans (host) --------------------------------------
    seg_first = [s * L for s in range(S)]
    seg_last = [min((s + 1) * L, nb) - 1 for s in range(S)]
    seg_row0 = [int(rows_[f]) for f in seg_first]
    seg_row1 = [
        int(rows_[l] + nrows_[l]) if l == nb - 1 else int(rows_[seg_first[s + 1]])
        for s, l in enumerate(seg_last)
    ]
    self._seg_rows = [r1 - r0 for r0, r1 in zip(seg_row0, seg_row1)]
    self._seg_row0 = seg_row0
    max_seg_rows = max(self._seg_rows)

    # boundary columns: first o cols of segments 1..S-1
    bcols = []
    for s in range(1, S):
        c0 = int(cols_[seg_first[s]])
        bcols.extend(range(c0, c0 + o))
    self._bcols_idx = np.asarray(bcols, dtype=np.int64)
    interior_mask = np.ones(self._ncols, dtype=bool)
    interior_mask[self._bcols_idx] = False
    self._icols_idx = np.nonzero(interior_mask)[0]
    self._m1 = int(self._icols_idx.size)  # total interior columns
    self._m2 = int(self._bcols_idx.size)

    # per-segment interior column counts and local offsets
    self._seg_ncols = []
    for s in range(S):
        f, l = seg_first[s], seg_last[s]
        c_end = int(cols_[l] + ncols_[l]) - o if l < nb - 1 else self._ncols
        c_begin = int(cols_[f]) + (o if s > 0 else 0)
        self._seg_ncols.append(c_end - c_begin)
    self._seg_col0 = np.concatenate([[0], np.cumsum(self._seg_ncols)])[:-1]

    # --- per-segment local plans + geometry (host) -----------------------------
    # Each segment is a standalone banded chain over its interior columns:
    # the leading o columns of segments 1.. and the trailing o columns of
    # segments ..S-2 are boundary (right-block) columns and are excluded.
    from ..plan import BlockInfo as _BI, StructurePlan as _SP

    mR = int(nrows_.max())
    seg_geoms = []
    seg_plans = []
    for s_i in range(S):
        f, l = seg_first[s_i], seg_last[s_i]
        colbase = int(cols_[f]) + (o if s_i > 0 else 0)
        blocks_s = []
        for i in range(f, l + 1):
            drop_lead = o if (s_i > 0 and i == f) else 0
            drop_tail = o if (s_i < S - 1 and i == l) else 0
            blocks_s.append(
                _BI(
                    int(rows_[i]) - seg_row0[s_i],
                    int(cols_[i]) + drop_lead - colbase,
                    int(nrows_[i]),
                    int(ncols_[i]) - drop_lead - drop_tail,
                )
            )
        plan_s = _SP(self._seg_rows[s_i], self._seg_ncols[s_i], tuple(blocks_s))
        seg_plans.append(plan_s)
        seg_geoms.append(banded_geometry(plan_s))

    # stacked [S, L] geometry (padded steps inactive)
    loc_geom = {
        k: np.zeros((S, L), dtype=np.int64)
        for k in ("carry_rows", "col_inc", "ncols", "nrows", "cols", "rows")
    }
    active = np.zeros((S, L), dtype=bool)
    emit = np.zeros((S, L), dtype=np.int64)
    max_cols = 1
    for s_i in range(S):
        gs = seg_geoms[s_i]
        nsteps = seg_last[s_i] - seg_first[s_i] + 1
        active[s_i, :nsteps] = True
        emit[s_i, :nsteps] = gs["emit_rows"]
        for k in loc_geom:
            loc_geom[k][s_i, :nsteps] = gs[k if k != "cols" else "cols"]
        max_cols = max(max_cols, int(gs["ncols"].max()))
    self._emit = emit

    # dense-panel descriptor list (rows local to segment, cols local to
    # block) — consumed by one native extraction call per factorize
    block_list = []
    for s_i in range(S):
        colbase = int(cols_[seg_first[s_i]]) + (o if s_i > 0 else 0)
        blocks_s = list(seg_plans[s_i].blocks)
        for j in range(L):
            if j < len(blocks_s):
                b = blocks_s[j]
                block_list.append(
                    (seg_row0[s_i] + b.row, colbase + b.col, b.nrows, b.ncols)
                )
            else:
                block_list.append((0, 0, 0, 0))
    self._block_list = block_list
    self._mRloc = mR

    self._kw = dict(
        max_active=max(int(g_s["active"].max()) for g_s in seg_geoms),
        max_cols=max_cols,
        max_carry=max(max(int(g_s["carry_rows"].max()) for g_s in seg_geoms), 1),
        max_emit=int(emit.max()),
    )
    self._max_cols = max_cols
    self._max_emit = self._kw["max_emit"]
    self._max_seg_rows = max_seg_rows
    self._loc_geom = loc_geom
    self._active = active
    # device-resident static metadata (transferred once per plan)
    self._starts = jnp.asarray(loc_geom["cols"], dtype=jnp.int32)
    self._carry_d = jnp.asarray(loc_geom["carry_rows"].reshape(-1), dtype=jnp.int32)
    self._carry2d = jnp.asarray(loc_geom["carry_rows"], dtype=jnp.int32)
    self._nrows_d = jnp.asarray(loc_geom["nrows"].reshape(-1), dtype=jnp.int32)
    self._colinc_d = jnp.asarray(loc_geom["col_inc"], dtype=jnp.int32)
    self._ncols_d = jnp.asarray(loc_geom["ncols"], dtype=jnp.int32)
    self._rows2d = jnp.asarray(loc_geom["rows"], dtype=jnp.int32)
    self._active_d = jnp.asarray(active)
    self._emit_d = jnp.asarray(emit, dtype=jnp.int32)
    self._seg_col0_d = jnp.asarray(self._seg_col0)

    # column permutation: P_split (interior-first) — A · P = Q · R
    self._cols_perm = Permutation(
        np.concatenate([self._icols_idx, self._bcols_idx])
    )

    # --- boundary chain (phase-3 structure) -------------------------------------
    # Segment s's bottom rows are nonzero only in boundary columns
    # [(s-1)o, (s+1)o); stacked in segment order they form a banded chain
    # of S blocks stepping o columns.  Block 0 (trailing boundary only)
    # and block S-1 (leading only) are o wide; interior blocks 2o.
    nloc_max = max(self._seg_ncols)
    self._nloc_max = nloc_max
    rbot = [self._seg_rows[si] - self._seg_ncols[si] for si in range(S)]
    if min(rbot) < 2 * o:
        raise ValueError(
            "segment bottom rows too few for the boundary chain; use BandedBlockedQR"
        )
    self._rbot = rbot
    rbot_max = max(rbot)
    self._rbot_max = rbot_max
    cum = np.concatenate([[0], np.cumsum(rbot)])
    self._nbot = int(cum[-1])
    # CAQR-style compression: each segment's [rbot, 2o] bottom slab is
    # first reduced by ONE vmapped QR to its [2o, 2o] R factor, and the
    # recursive boundary chain runs over those tiny factors — S sequential
    # steps on [3o, 2o]-ish panels instead of [rbot + o, 2o] ones, and the
    # per-segment reduction is batch-parallel (and shard-parallel across
    # chips).  Q composes as blockdiag(Qb_s) · Q_chain.
    self._nbot2 = S * 2 * o
    chain_blocks = []
    for si in range(S):
        c0b = max(0, si - 1) * o
        ncb = min(2 * o, self._m2 - c0b) if 0 < si < S - 1 else o
        chain_blocks.append(_BI(si * 2 * o, int(c0b), 2 * o, int(ncb)))
    # Re-block the chain into groups of G consecutive factors.  The scan
    # over the compressed chain is per-step-latency-bound (625 steps of
    # [3o, 2o] panels at 20k blocks, in the factorize and in both solve
    # scans); G-fold grouping cuts the step count G-fold — and the
    # total reflector count too, since only one o-column carry overlap is
    # refactorized per GROUP instead of per block.  G is capped so the
    # grouped panel stays on the unrolled panel-QR path ((G+1)·o ≤ 32
    # columns), and grouping only engages on long chains.
    G = 1
    if S >= 24:
        G = max(1, min(32 // o - 1, S // 8))
    self._chain_group = G
    if G > 1:
        gblocks = []
        for g0 in range(0, S, G):
            blks = chain_blocks[g0 : g0 + G]
            c0g = min(b.col for b in blks)
            c1g = max(b.col + b.ncols for b in blks)
            gblocks.append(
                _BI(blks[0].row, c0g, sum(b.nrows for b in blks), c1g - c0g)
            )
        Sg = len(gblocks)
        mrg = max(b.nrows for b in gblocks)
        mcg = max(b.ncols for b in gblocks)
        # map scattering comp's [S, 2o, 2o] entries into grouped panels
        # (sentinel = index of the appended zero)
        rmap = np.full((Sg, mrg, mcg), S * 4 * o * o, dtype=np.int64)
        for g0 in range(0, S, G):
            g = g0 // G
            gb = gblocks[g]
            for i, b in enumerate(chain_blocks[g0 : g0 + G]):
                r0 = b.row - gb.row
                c0 = b.col - gb.col
                idx = (
                    (g0 + i) * 4 * o * o
                    + np.arange(2 * o)[:, None] * 2 * o
                    + np.arange(b.ncols)[None, :]
                )
                rmap[g, r0 : r0 + 2 * o, c0 : c0 + b.ncols] = idx
        self._chain_regroup = jnp.asarray(rmap)
        chain_plan = _SP(self._nbot2, self._m2, tuple(gblocks))
    else:
        self._chain_regroup = None
        chain_plan = _SP(self._nbot2, self._m2, tuple(chain_blocks))
    cg = banded_geometry(chain_plan)
    self._chain_geom = cg
    self._chain_geom_dev = {
        k: jnp.asarray(cg[k])
        for k in ("carry_rows", "col_inc", "nrows", "cols", "rows")
    }
    self._chain_kw = dict(
        max_active=int(cg["active"].max()),
        max_cols=int(cg["ncols"].max()),
        max_carry=max(int(cg["carry_rows"].max()), 1),
        max_emit=int(cg["emit_rows"].max()),
    )
    self._chain_solve_meta = (
        jnp.asarray(cg["cols"]),
        jnp.asarray(cg["emit_rows"]),
        jnp.asarray(cg["ncols"]),
    )
    # device gather maps between padded segment rows and the chain layout
    seg_ncols_a = np.asarray(self._seg_ncols)
    self._top_valid = jnp.asarray(
        np.arange(nloc_max)[None, :] < seg_ncols_a[:, None]
    )
    # each segment's bottom rows are the contiguous run starting right
    # after its local columns — the factorize cuts them with one batched
    # dynamic_slice instead of an element gather
    self._bot_starts = _imap(np.minimum(seg_ncols_a, max_seg_rows))
    self._bot_valid = jnp.asarray(
        np.arange(rbot_max)[None, :] < np.asarray(rbot)[:, None]
    )
    # x2 window per segment: x2seg[s, j] = x2[(s-1)o + j] (zero out of range)
    self._x2_idx = _imap(
        np.arange(S)[:, None] * o + np.arange(2 * o)[None, :]
    )
    self._seg_row0_arr = np.asarray(self._seg_row0)

    # bottom-region maps for the compressed (CAQR) boundary reduction:
    # the [nbot] bottom vector (segment-major rbot[s] rows each) maps to a
    # padded [S, rbot_max] batch for the vmapped Qb applies; after Qbᵀ the
    # leading 2o rows of each segment feed the chain (positions [0, S·2o)
    # of the output) and the remaining rows pass through behind them.
    rg = np.full((S, rbot_max), self._nbot, dtype=np.int64)
    for s in range(S):
        rg[s, : rbot[s]] = int(cum[s]) + np.arange(rbot[s])
    rest_w = max(rbot_max - 2 * o, 1)
    cum_rest = np.concatenate([[0], np.cumsum([r - 2 * o for r in rbot])])
    rp = np.full((S, rest_w), self._nbot, dtype=np.int64)
    for s in range(S):
        n = rbot[s] - 2 * o
        rp[s, :n] = self._nbot2 + int(cum_rest[s]) + np.arange(n)
    self._rbot_gather = _imap(rg)
    self._rbot_valid = jnp.asarray(rg < self._nbot)
    # lane-major twins for the fused solve's SoA bottom apply
    # (segments minor — matches the SoA Yb store)
    self._rbot_gather_t = _imap(rg.T)
    self._rbot_valid_t = jnp.asarray(np.ascontiguousarray((rg < self._nbot).T))
    self._rest_pos = _imap(rp)
    self._prepare_p2_gate()

def prepare_p2_gate(self):
    """Gate + scalars for the shared-window phase-2 batch apply
    (:func:`_segment_apply_cols_shared`): segments 1.. must share one
    s1/s2/split sequence on their active prefixes (interior segments of a
    uniform chain do; the padded tail's inactive steps are no-ops), and
    the composed-window slice needs ``split <= s2`` everywhere."""
    S, L = self.S, self.L
    lg, act = self._loc_geom, self._active
    nuni = 0
    if S >= 2:
        s1u = lg["cols"][1].astype(np.int32)
        s2u = lg["rows"][1].astype(np.int32)
        spu = lg["carry_rows"][1].astype(np.int32)
        if bool((s2u >= spu).all()):
            # maximal run of segments (from 1) matching the shared
            # scalars on their active prefixes; an irregular tail (the
            # final chain block carries no trailing overlap) stays on
            # the general per-segment path
            for s in range(1, S):
                n = int(act[s].sum())
                if (
                    bool((lg["cols"][s][:n] == s1u[:n]).all())
                    and bool((lg["rows"][s][:n] == s2u[:n]).all())
                    and bool((lg["carry_rows"][s][:n] == spu[:n]).all())
                ):
                    nuni += 1
                else:
                    break
    self._p2_nuni = nuni if nuni >= 2 else 0
    self._p2_uniform = self._p2_nuni > 0
    self._bs_uniform = False
    if self._p2_uniform:
        self._s1u = jnp.asarray(s1u)
        self._s2u = jnp.asarray(s2u)
        self._spu = jnp.asarray(spu)
        # host tuples select the unrolled-static uniform apply (the
        # scalars are plan constants; static slices let XLA update the
        # phase-2 work buffer in place instead of re-materializing it
        # per scan step)
        self._p2_static = (
            tuple(int(x) for x in s1u),
            tuple(int(x) for x in s2u),
            tuple(int(x) for x in spu),
            _p2_stream_plan(
                s1u, s2u, spu, int(self._kw["max_active"]), self.L,
                int(self._max_seg_rows),
            ),
        )
        # per-segment scalar tuples for the general (irregular) segments,
        # trimmed to active steps, enabling their unrolled-static stream
        A_ = int(self._kw["max_active"])
        R_ = int(self._max_seg_rows)
        gen = []
        for s in [0] + list(range(1 + self._p2_nuni, S)):
            n = int(act[s].sum())
            g = (
                tuple(int(x) for x in lg["cols"][s][:n]),
                tuple(int(x) for x in lg["rows"][s][:n]),
                tuple(int(x) for x in lg["carry_rows"][s][:n]),
            )
            if _p2_stream_plan(g[0], g[1], g[2], A_, n, R_) is None:
                gen = None
                break
            gen.append(g)
        self._p2_gen_static = tuple(gen) if gen is not None else None
        # back-substitution gate: its shared run additionally needs the
        # (emit-rows, ncols) sequences equal on active prefixes — the
        # FINAL segment usually breaks this (its last chain block has no
        # trailing overlap, so it emits all its columns), so the run
        # length is tracked separately from nuni; the unrolled
        # triangular solve is bounded to <=16 emit rows
        em, ncl = self._emit, lg["ncols"]
        eru = em[1].astype(np.int32)
        ncu = ncl[1].astype(np.int32)
        bs_nuni = 0
        if self._kw["max_emit"] <= 16:
            for s in range(1, 1 + self._p2_nuni):
                n = int(act[s].sum())
                if np.array_equal(em[s][:n], eru[:n]) and np.array_equal(
                    ncl[s][:n], ncu[:n]
                ):
                    bs_nuni += 1
                else:
                    break
        self._bs_nuni = bs_nuni if bs_nuni >= 2 else 0
        self._bs_uniform = self._bs_nuni > 0
        if self._bs_uniform:
            self._eru = jnp.asarray(eru)
            self._ncu = jnp.asarray(ncu)
            # host tuples select the unrolled-static back-substitution
            # (static slices + only-er-rows triangular unroll; the scan
            # form pays a step latency per block)
            self._bs_static = (
                tuple(int(x) for x in s1u),
                tuple(int(x) for x in eru),
                tuple(int(x) for x in ncu),
            )
            self._bs_gen_static = tuple(
                (
                    tuple(int(x) for x in lg["cols"][s][: int(act[s].sum())]),
                    tuple(int(x) for x in em[s][: int(act[s].sum())]),
                    tuple(int(x) for x in ncl[s][: int(act[s].sum())]),
                )
                for s in [0] + list(range(1 + self._bs_nuni, S))
            )

def detect_panel_fast(self, gm: np.ndarray, nnz: int):
    """Host-side gather-free panel-extraction detection (once per layout).

    Recognized form: every panel's stored entries sit at a constant offset
    ``delta`` from their own linear position in a ``[S*L, mR, mc]``
    row-major layout of the data vector, with ``delta == 0`` everywhere
    except possibly the first panel of each segment (the dropped leading
    overlap shifts those by one shared value ``d0``).  Row-sorted banded
    layouts — every LM-pattern Jacobian built block-row-major — satisfy
    this; row-permuted/analyzed layouts fall back to the element gather.
    Returns ``None`` or ``dict(mask, d0, l0shift)``.
    """
    S, L = self.S, self.L
    g = gm.reshape(S * L, -1).astype(np.int64)
    valid = g != nnz
    lin = np.arange(g.size, dtype=np.int64).reshape(g.shape)
    delta = np.where(valid, g - lin, 0)
    big = np.iinfo(np.int64)
    dmax = np.where(valid, delta, big.min).max(axis=1)
    dmin = np.where(valid, delta, big.max).min(axis=1)
    has = valid.any(axis=1)
    if not bool((~has | (dmax == dmin)).all()):
        return None
    dval = np.where(has, dmax, 0).reshape(S, L)
    if bool((dval[:, 1:] != 0).any()) or dval[0, 0] != 0:
        return None
    nz = np.unique(dval[:, 0][dval[:, 0] != 0])
    if nz.size > 1:
        return None
    d0 = int(nz[0]) if nz.size else 0
    ew = gm.shape[1] * gm.shape[2]
    if d0 and not (0 < d0 <= (L - 1) * ew):
        return None
    return dict(
        mask=jnp.asarray(valid.reshape(gm.shape)),
        d0=d0,
        l0shift=jnp.asarray(dval[:, 0] != 0) if d0 else None,
    )

