"""Blocked thin QR — tall, mostly-dense matrices in fixed-width panels.

Accelerator re-design of ``BlockedThinQRBase`` + ``BlockedThinDenseQR`` +
``BlockedThinSparseQR`` (/root/reference/src/QRKit/BlockedThinQRBase.h,
BlockedThinDenseQR.h, BlockedThinSparseQR.h).  Left-looking panel factorization:
per panel a compact-WY QR, then ONE trailing-update matmul (the reference's
``updateMat`` OpenMP-per-column loop, BlockedThinQRBase.h:308-319, becomes a
single GEMM).  Q is a :class:`CompactWYSeq` whose windows start
at the panel's diagonal row.

The sparse variant adds the reference's orderings (column-density column perm +
as-banded-as-possible row perm, BlockedThinSparseQR.h:168-201), restricts each
panel to its sparsity row extent (``updateBlockInfo``, :203-236) and pivots
columns inside each panel (ColPivHouseholderQR analog), composing the pivots
into the output column permutation (:150-159).
"""
from __future__ import annotations

import functools
from typing import List, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..analysis import as_banded_as_possible, column_density
from ..ops.compact_wy import CompactWYSeq
from ..ops.householder import (
    apply_wy,
    build_t_factor,
    colpiv_householder_qr,
    highest_precision,
    panel_qr_yt,
    rank_from_diag,
    rank_masked_triangular_solve,
)
from ..sparse import Permutation, SparseCSR
from .base import ComputationInfo, QRSolver, _diag_health

__all__ = ["BlockedThinDenseQR", "BlockedThinSparseQR"]


@functools.partial(jax.jit, static_argnames=("n", "check_zero"))
def _thin_finish_r(working, n: int, check_zero: bool):
    """triu + pivot diagonal + info() health scalar as ONE program (the eager
    triple costs three dispatches per factorize)."""
    R = jnp.triu(working)
    d = jnp.diagonal(R[:n, :n])
    return R, d, _diag_health(d, check_zero=check_zero)


def _panel_starts(n: int, c: int) -> List[int]:
    return list(range(0, n, c))


@functools.partial(jax.jit, static_argnames=("c",))
def _thin_dense_factorize(A: jnp.ndarray, c: int):
    """Panel loop over a dense [m, n]: returns (Y [nb,m,c], T [nb,c,c], R [m,n])."""
    m, n = A.shape
    dt = A.dtype
    Ys, Ts = [], []
    R = A
    for p0 in _panel_starts(n, c):
        pc = min(c, n - p0)
        Y, T, Rp = panel_qr_yt(R[:, p0 : p0 + pc], offset=p0)
        R = R.at[:, p0 : p0 + pc].set(Rp)
        if p0 + pc < n:
            R = R.at[:, p0 + pc :].set(
                apply_wy(Y, T, R[:, p0 + pc :], transpose=True)
            )
        if pc < c:  # pad final narrow panel
            Y = jnp.concatenate([Y, jnp.zeros((m, c - pc), dt)], axis=1)
            T = jnp.pad(T, ((0, c - pc), (0, c - pc)))
        Ys.append(Y)
        Ts.append(T)
    return jnp.stack(Ys), jnp.stack(Ts), jnp.triu(R)


class BlockedThinDenseQR(QRSolver):
    """Thin QR of a dense matrix, fixed-width panels, no permutations, not
    rank-revealing (BlockedThinDenseQR.h:104-176)."""

    def __init__(self, suggested_block_cols: int = 2):
        self.c = suggested_block_cols

    @property
    def rows(self) -> int:
        return self._m

    @property
    def cols(self) -> int:
        return self._n

    def compute(self, mat) -> "BlockedThinDenseQR":
        if isinstance(mat, SparseCSR):
            mat = jnp.asarray(mat.to_dense())
        mat = jnp.asarray(mat)
        self._m, self._n = map(int, mat.shape)
        if self._n > 64:
            # wide input: the per-panel python loop unrolls O(n) reflectors at
            # trace time; one backend-native blocked QR gives the identical
            # contract (same Q·R, no perms, not rank-revealing) at O(1) trace
            Y, T, R = panel_qr_yt(mat)
            self.q_seq = CompactWYSeq.single(Y, T, 0, self._m)
            self._R = jnp.triu(R)
            self._set_success()
            return self
        Y, T, R = _thin_dense_factorize(mat, self.c)
        starts = np.asarray(_panel_starts(self._n, self.c), dtype=np.int32) * 0
        # windows span full height (Y has zeros above the panel diagonal)
        self.q_seq = CompactWYSeq(Y, T, jnp.asarray(starts), self._m)
        self._R = R
        self._set_success()
        return self

    def apply_q(self, m: jnp.ndarray) -> jnp.ndarray:
        return self.q_seq.apply_q(m)

    def apply_qt(self, m: jnp.ndarray) -> jnp.ndarray:
        return self.q_seq.apply_qt(m)

    def matrix_r_dense(self) -> jnp.ndarray:
        return self._R

    def solve_r(self, y: jnp.ndarray) -> jnp.ndarray:
        return jax.lax.linalg.triangular_solve(
            self._R[: self._n, : self._n], y[:, None], left_side=True, lower=False
        )[:, 0]


def _height_runs(heights: List[int], c: int) -> tuple:
    """Group consecutive full-width panels into runs of equal *height bucket*
    (next power of two ≥ the panel's sparsity extent, capped at max(heights)).
    Static plan data: ``((count, bucket_height), ...)``.

    Bucketing bounds padded work at 2× the true extent while keeping the
    number of distinct compiled scan bodies O(log(maxh/c)); the cap keeps the
    worst case no worse than the old uniform-``maxh`` scan."""
    maxh = max(heights)
    runs: List[List[int]] = []
    for h in heights:
        hb = min(max(c, 1 << (int(h) - 1).bit_length()), maxh)
        if runs and runs[-1][1] == hb:
            runs[-1][0] += 1
        else:
            runs.append([1, hb])
    return tuple((cnt, hb) for cnt, hb in runs)


@functools.partial(jax.jit, static_argnames=("c", "runs", "maxh"))
@highest_precision
def _thin_sparse_factorize_runs(workpad: jnp.ndarray, c: int, runs: tuple,
                                maxh: int):
    """All full-width panels of the thin sparse factorization as ONE jitted
    program — O(1) dispatches per factorize instead of two jitted calls plus
    host slicing per panel (~500 dispatches at n=512, c=2).

    The panel sequence is split into the static ``runs`` of
    :func:`_height_runs`; each run is a ``lax.scan`` whose panel/window
    slices are that run's bucket height, so per-panel trailing-update work is
    O(h_p·n) tracking the sparsity extents of ``_panel_heights`` (the
    reference's updateBlockInfo economy, BlockedThinSparseQR.h:203-236)
    rather than O(maxh·n) — previously every panel paid the global maximum.

    ``workpad`` is the dense working matrix padded with ``maxh`` zero rows so
    every [hb, c] panel slice is in-bounds.  Rows past a panel's true nnz
    extent (≤ its bucket height) are structurally zero, Householder
    reflectors inherit those zeros, and the trailing compact-WY update is an
    exact identity there — the bucket-padded panel computes bit-for-bit the
    same factors as the extent-sliced one (zeros are exact identity elements
    of every sum involved).

    Returns (workpad, Ys [nfull, maxh, c], Ts [nfull, c, c],
    lperms [nfull, c]); Y rows above each run's bucket are zero.
    """
    mpad, n = workpad.shape
    col_iota = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    dt = workpad.dtype

    def make_body(hb):
        def body(wp, i):
            p0 = i * c
            zero = jnp.zeros((), p0.dtype)
            # in-panel ColPiv on the unpermuted panel, then the full-height
            # column reorder (incl. rows above the diagonal — the R assembly
            # of BlockedThinSparseQR.h:271-279)
            panel = jax.lax.dynamic_slice(wp, (p0, p0), (hb, c))
            Y, taus, Rsub, lperm = colpiv_householder_qr(panel)
            T = build_t_factor(Y, taus)
            colwin = jax.lax.dynamic_slice(wp, (zero, p0), (mpad, c))
            wp = jax.lax.dynamic_update_slice(wp, colwin[:, lperm], (zero, p0))
            # trailing update on columns past the panel; R into the panel
            win = jax.lax.dynamic_slice(wp, (p0, zero), (hb, n))
            upd = apply_wy(Y, T, win, transpose=True)
            win = jnp.where((col_iota >= p0 + c)[None, :], upd, win)
            win = jax.lax.dynamic_update_slice(win, jnp.triu(Rsub), (zero, p0))
            wp = jax.lax.dynamic_update_slice(wp, win, (p0, zero))
            return wp, (Y, T, lperm)

        return body

    Y_parts, T_parts, lp_parts = [], [], []
    i0 = 0
    for cnt, hb in runs:
        steps = jnp.arange(i0, i0 + cnt, dtype=jnp.int32)
        workpad, (Ys, Ts, lps) = jax.lax.scan(make_body(hb), workpad, steps)
        if hb < maxh:  # uniform stack height for CompactWYSeq
            Ys = jnp.concatenate(
                [Ys, jnp.zeros((cnt, maxh - hb, c), dt)], axis=1
            )
        Y_parts.append(Ys)
        T_parts.append(Ts)
        lp_parts.append(lps)
        i0 += cnt
    cat = (lambda xs: xs[0] if len(xs) == 1 else jnp.concatenate(xs, axis=0))
    return workpad, cat(Y_parts), cat(T_parts), cat(lp_parts)


class BlockedThinSparseQR(QRSolver):
    """Thin QR of a sparse (or dense) matrix with orderings and per-panel
    column pivoting (BlockedThinSparseQR.h:105-283).

    Panels are restricted to their sparsity row extent so factorization cost
    tracks nnz structure, not the full height.  Zero-pivot columns are tracked
    into a Householder column permutation (:150-159) with exact ``rank()``;
    rank-deficient solves complete the decomposition (one small ColPiv QR of
    R) and return the residual-optimal basic solution.

    ``fused=True`` (default) runs all full-width panels as ONE compiled
    program (one dispatch per factorize) built from height-bucketed
    ``lax.scan`` runs, so each panel's work is O(h_p·n) per its sparsity
    extent; ``fused=False`` keeps the eager per-panel loop (regression
    cross-check — identical factors).
    """

    _health_check_zero_pivot = False  # rank-revealing: deficiency reported via rank()

    def __init__(self, suggested_block_cols: int = 2, fused: bool = True):
        self.c = suggested_block_cols
        self.fused = fused

    @property
    def rows(self) -> int:
        return self._m

    @property
    def cols(self) -> int:
        return self._n

    def _analyze(self, mat: SparseCSR):
        col_perm = column_density(mat)
        pmat = mat.permute_cols(col_perm)
        row_perm, has_rp = as_banded_as_possible(pmat)
        if has_rp:
            pmat = pmat.permute_rows(row_perm)
        return pmat, col_perm, row_perm

    def _panel_heights(self, pmat: SparseCSR) -> List[int]:
        """updateBlockInfo analog (BlockedThinSparseQR.h:203-236): per panel,
        rows = max nnz row extent of the panel's columns; never shrink by more
        than the panel width relative to the previous panel."""
        m, n = pmat.shape
        _, ends = pmat.row_ranges()
        heights = []
        prev_h = 0
        # per-column last nonzero row
        col_max_row = np.full(n, -1, dtype=np.int64)
        row_ids = np.repeat(np.arange(m), np.diff(pmat.indptr))
        np.maximum.at(col_max_row, pmat.indices, row_ids)
        for p0 in _panel_starts(n, self.c):
            pc = min(self.c, n - p0)
            if p0 + pc >= n:
                h = m - p0
            else:
                biggest = int(col_max_row[p0 : p0 + pc].max())
                h = biggest - p0 + 1
                h = max(h, prev_h - pc)
            h = max(h, pc)  # need at least pc rows for a full-rank panel
            h = min(h, m - p0)
            heights.append(h)
            prev_h = h
        return heights

    def _eager_panel(self, working, p0: int, h: int, pc: int, maxh: int, house):
        """One eager panel step (the ragged final panel, and the fused=False
        cross-check path)."""
        dt = working.dtype
        sub = working[p0 : p0 + h, p0 : p0 + pc]
        Y, taus, Rsub, lperm = colpiv_householder_qr(sub)
        T = build_t_factor(Y, taus)
        # physically reorder the panel's columns (incl. rows above diagonal,
        # matching the R assembly of BlockedThinSparseQR.h:271-279)
        working = working.at[:, p0 : p0 + pc].set(working[:, p0 + lperm])
        house[p0 : p0 + pc] = house[p0 + np.asarray(lperm)]
        working = working.at[p0 : p0 + h, p0 : p0 + pc].set(jnp.triu(Rsub))
        if p0 + pc < self._n:
            working = working.at[p0 : p0 + h, p0 + pc :].set(
                apply_wy(Y, T, working[p0 : p0 + h, p0 + pc :], transpose=True)
            )
        Yp = jnp.zeros((maxh, self.c), dt).at[:h, :pc].set(Y)
        Tp = jnp.zeros((self.c, self.c), dt).at[:pc, :pc].set(T)
        return working, Yp, Tp

    def compute(self, mat: Union[SparseCSR, jnp.ndarray]) -> "BlockedThinSparseQR":
        if not isinstance(mat, SparseCSR):
            mat = SparseCSR.from_dense(np.asarray(mat))
        self._m, self._n = mat.shape
        pmat, self._col_perm, self._row_perm = self._analyze(mat)
        heights = self._panel_heights(pmat)
        working = jnp.asarray(pmat.to_dense())
        dt = working.dtype
        maxh = max(heights)
        n, c = self._n, self.c
        house = np.arange(n, dtype=np.int64)
        nfull = n // c
        if self.fused and nfull > 0:
            # all full-width panels in ONE compiled program (one scan per
            # height-bucket run); the device never round-trips per panel and
            # per-panel work tracks the sparsity extents of _panel_heights
            # (see _thin_sparse_factorize_runs)
            runs = _height_runs(heights[:nfull], c)
            workpad = jnp.concatenate([working, jnp.zeros((maxh, n), dt)], axis=0)
            workpad, Y_stack, T_stack, lperms = _thin_sparse_factorize_runs(
                workpad, c, runs, maxh
            )
            working = workpad[: self._m]
            lp = np.asarray(lperms)  # ONE fetch for every panel's pivots
            for i in range(nfull):
                house[i * c : (i + 1) * c] = house[i * c + lp[i]]
            starts = [i * c for i in range(nfull)]
            if nfull * c < n:  # ragged final panel
                p0, pc = nfull * c, n - nfull * c
                working, Yp, Tp = self._eager_panel(
                    working, p0, heights[-1], pc, maxh, house
                )
                Y_stack = jnp.concatenate([Y_stack, Yp[None]], axis=0)
                T_stack = jnp.concatenate([T_stack, Tp[None]], axis=0)
                starts.append(p0)
        else:
            Ys, Ts, starts = [], [], []
            for (p0, h) in zip(_panel_starts(n, c), heights):
                pc = min(c, n - p0)
                working, Yp, Tp = self._eager_panel(working, p0, h, pc, maxh, house)
                Ys.append(Yp)
                Ts.append(Tp)
                starts.append(p0)
            Y_stack, T_stack = jnp.stack(Ys), jnp.stack(Ts)
        self.q_seq = CompactWYSeq(
            Y_stack, T_stack, jnp.asarray(starts, dtype=jnp.int32), self._m
        )
        self._R, self._diag_dev, self._health_dev = _thin_finish_r(
            working, n=self._n, check_zero=self._health_check_zero_pivot
        )
        # combined column permutation: density ordering then in-panel pivots
        # (m_outputPerm_c * m_houseColPerm, BlockedThinSparseQR.h:159)
        sigma1 = self._col_perm.indices
        self._out_col_perm = Permutation(sigma1[house])

        # zero-pivot column tracking (BlockedThinSparseQR.h:150-159, 251-256):
        # columns whose R pivot is numerically zero are recorded and pushed to
        # the back of the Householder column permutation; rank() is exact.
        # The diagonal stays on the device — the bookkeeping host fetch is
        # LAZY (first rank()/house perm/solve access), so factorize itself
        # never blocks on a device round trip.
        self._deficiency_cache = None
        self._repair = None  # lazy COD factors for rank-deficient solves

        self._set_success(self._health_dev)
        return self

    def _deficiency(self):
        """(exact rank, house column permutation) — fetched/derived once."""
        if self._deficiency_cache is None:
            diag = np.abs(np.asarray(self._diag_dev))
            tol = (diag.max() if diag.size else 0.0) * max(self._m, self._n) * np.finfo(
                np.float64
            ).eps
            live = diag > tol
            rank = int(live.sum())
            order = np.concatenate(
                [np.nonzero(live)[0], np.nonzero(~live)[0]]
            )  # order[newpos] = workingpos
            house_perm = np.empty(self._n, dtype=np.int64)
            house_perm[order] = np.arange(self._n)
            self._deficiency_cache = (rank, Permutation(house_perm))
        return self._deficiency_cache

    def house_cols_permutation(self) -> Permutation:
        """Permutation pushing zero-pivot columns (in pivoted working order) to
        the back — the reference's m_houseColPerm (BlockedThinSparseQR.h:150-159)."""
        return self._deficiency()[1]

    def deficient_cols(self) -> np.ndarray:
        """Original column indices of the zero-pivot columns."""
        rank, house = self._deficiency()
        inv = house.inverse().indices  # newpos -> workingpos
        return np.asarray(self._out_col_perm.indices)[inv[rank:]]

    def apply_q(self, m: jnp.ndarray) -> jnp.ndarray:
        return self.q_seq.apply_q(m)

    def apply_qt(self, m: jnp.ndarray) -> jnp.ndarray:
        return self.q_seq.apply_qt(m)

    def matrix_r_dense(self) -> jnp.ndarray:
        return self._R

    def solve_r(self, y: jnp.ndarray) -> jnp.ndarray:
        n = self._n
        R = self._R[:n, :n]
        if self._deficiency()[0] == n:
            return jax.lax.linalg.triangular_solve(
                R, y[:n, None], left_side=True, lower=False
            )[:, 0]
        # Rank-deficient: per-panel pivoting leaves dead pivots scattered, so a
        # prefix mask is not enough.  Complete the decomposition with one small
        # n×n ColPiv QR of R (R·P2 = Q2·R2, dead pivots now clustered) and take
        # the basic solution — residual-optimal over the live pivot columns.
        if self._repair is None:
            from .dense import _dense_colpiv_qr

            self._repair = _dense_colpiv_qr(R)
        Y2, T2, R2, perm2 = self._repair
        yq = apply_wy(Y2, T2, y[:n], transpose=True)
        k = rank_from_diag(jnp.diagonal(R2[:n]), n, n)
        z = rank_masked_triangular_solve(jnp.triu(R2[:n]), yq[:n], k)
        return jnp.zeros((n,), z.dtype).at[perm2].set(z)

    def cols_permutation(self) -> Permutation:
        return self._out_col_perm

    def rows_permutation(self) -> Permutation:
        return self._row_perm

    @property
    def rank(self) -> int:
        """Exact numerical rank (from the R pivots; fetched lazily)."""
        return self._deficiency()[0]
