"""Dense panel Householder QR in compact-WY form — the batched-GEMM workhorse.

Accelerator replacement for the reference's per-block ``Eigen::HouseholderQR`` +
``make_block_householder_triangular_factor`` calls
(/root/reference/src/QRKit/BandedBlockedSparseQR.h:468-477,
BlockedThinQRBase.h:321-333).  All shapes are static; the per-column loop is
unrolled at trace time and the trailing updates are matmuls, so a ``vmap`` over a
block batch turns the whole factorization into large batched GEMMs.

Conventions (identical to the reference so factors are interchangeable):

* ``Y`` is unit-lower-trapezoidal ([m, n], implicit ones ON the diagonal stored
  explicitly, zeros above), the "essential" Householder vectors.
* ``T`` is the *negated* triangular factor: ``Q = H_0 H_1 ... H_{n-1} = I + Y T Yᵀ``
  (the reference stores ``T = -T_std``, BandedBlockedSparseQR.h:477).
* ``Q  v = v + Y (T  (Yᵀ v))``  and  ``Qᵀ v = v + Y (Tᵀ (Yᵀ v))``
  (BlockYTY.h:152-172, SparseBlockYTY.h:101-139).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "highest_precision",
    "householder_qr_unblocked",
    "build_t_factor",
    "panel_qr_yt",
    "colpiv_householder_qr",
    "apply_wy",
    "form_q",
    "batched_panel_qr_yt",
    "panel_qr_yt_soa",
]


def highest_precision(fn):
    """Trace ``fn`` with full-precision matmuls.

    On an NVIDIA GPU a float32 ``jnp.dot``/``@``/``einsum`` at the default
    precision may run on the tensor cores in TF32 (about three decimal
    digits) — fine for neural nets, wrong for a QR factorization
    (orthogonality degrades to ~1e-3).  Every kernel entry point in this
    library is wrapped so its matmuls request HIGHEST precision (full fp32);
    the blocks are small and latency/bandwidth-bound, so the slower matmul
    path costs little.  tests/test_chip_smoke.py audits the main paths for
    any matmul traced outside such a scope.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def _householder_column(A: jnp.ndarray, j: int, offset: int):
    """One Householder reflection eliminating column ``j`` below row ``offset+j``.

    Returns (A_updated, v, tau) with v the full-length reflector (v[pivot]=1,
    zeros above pivot).  Degenerate columns (zero tail) yield tau = 0 (H = I),
    matching Eigen's makeHouseholder convention.
    """
    m = A.shape[0]
    dt = A.dtype
    piv = offset + j
    col = A[:, j]
    rows = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    tail_mask = rows > piv
    x0 = col[piv]
    tail = jnp.where(tail_mask, col, jnp.zeros((), dt))
    sigma = jnp.sum(tail * tail)
    norm = jnp.sqrt(x0 * x0 + sigma)
    sign = jnp.where(x0 >= 0, jnp.ones((), dt), -jnp.ones((), dt))
    beta = -sign * norm
    degenerate = sigma <= jnp.zeros((), dt)
    safe_denom = jnp.where(degenerate, jnp.ones((), dt), x0 - beta)
    v = jnp.where(tail_mask, col / safe_denom, jnp.zeros((), dt))
    v = v.at[piv].set(jnp.ones((), dt))
    safe_beta = jnp.where(norm == 0, jnp.ones((), dt), beta)
    tau = jnp.where(degenerate, jnp.zeros((), dt), (beta - x0) / safe_beta)
    # H A = A - tau v (vᵀ A)
    w = tau * (v @ A)
    A = A - jnp.outer(v, w)
    return A, v, tau


@highest_precision
def householder_qr_unblocked(
    A: jnp.ndarray, offset: int = 0
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Unblocked Householder QR of ``A`` [m, n] with pivots on row ``offset + j``.

    Returns (Y [m, n], taus [n], A_reduced [m, n]); ``A_reduced`` holds R in its
    upper-trapezoidal part (rows ``offset..offset+n``).
    """
    m, n = A.shape
    ys = []
    taus = []
    for j in range(n):
        A, v, tau = _householder_column(A, j, offset)
        ys.append(v)
        taus.append(tau)
    Y = jnp.stack(ys, axis=1) if n else jnp.zeros((m, 0), A.dtype)
    tau_vec = jnp.stack(taus) if n else jnp.zeros((0,), A.dtype)
    return Y, tau_vec, A


@highest_precision
def build_t_factor(Y: jnp.ndarray, taus: jnp.ndarray) -> jnp.ndarray:
    """Compact-WY triangular factor with the reference's sign convention.

    Computes the standard forward recurrence for T_std (upper triangular,
    ``H_0..H_{n-1} = I - Y T_std Yᵀ``) and returns ``-T_std`` so that
    ``Q = I + Y T Yᵀ`` (BandedBlockedSparseQR.h:476-477).
    """
    n = Y.shape[1]
    T = jnp.zeros((n, n), Y.dtype)
    for j in range(n):
        tau = taus[j]
        if j > 0:
            z = Y[:, :j].T @ Y[:, j]
            T = T.at[:j, j].set(-tau * (T[:j, :j] @ z))
        T = T.at[j, j].set(tau)
    return -T


def _combine_t(T1, T2, Y1, Y2):
    """T for [Y1|Y2] given per-panel factors (negated convention):
    (I + Y1 T1 Y1ᵀ)(I + Y2 T2 Y2ᵀ) = I + [Y1 Y2] [[T1, T1 Y1ᵀY2 T2],[0, T2]] [..]ᵀ."""
    n1, n2 = T1.shape[0], T2.shape[0]
    cross = T1 @ (Y1.T @ Y2) @ T2
    top = jnp.concatenate([T1, cross], axis=1)
    bot = jnp.concatenate([jnp.zeros((n2, n1), T1.dtype), T2], axis=1)
    return jnp.concatenate([top, bot], axis=0)


_LAPACK_QR_MIN_WIDTH = 32


@highest_precision
def panel_qr_yt(
    A: jnp.ndarray, offset: int = 0, panel_width: int = 16
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Blocked compact-WY QR: returns (Y [m, n], T [n, n], R [m, n]).

    Recursively splits wide panels so the trailing update is a single large
    matmul chain per sub-panel — large GEMMs for thin-QR workloads.
    ``R`` is the reduced matrix (upper-trapezoidal below row ``offset``).

    Panels wider than ``_LAPACK_QR_MIN_WIDTH`` (with offset 0) delegate to the
    backend's native blocked QR (:func:`panel_qr_yt_lapack`) — the unrolled
    recursion's trace size and per-reflector pass count grow with the width,
    which made e.g. a 400-boundary-column factorization both compile- and
    run-bound.
    """
    m, n = A.shape
    if offset == 0 and n > _LAPACK_QR_MIN_WIDTH and m >= n:
        # portrait only: geqrf yields min(m, n) reflectors, so the landscape
        # case must keep the recursive path (whose trapezoidal Y handles it).
        # (measure any on-device QᵀQ probe in fp64 on the host — an fp32
        # verification matmul outside a highest-precision scope itself runs
        # in TF32 and reads as a false ~1e-3 failure)
        return panel_qr_yt_lapack(A, panel_width)
    if n <= panel_width:
        Y, taus, Ared = householder_qr_unblocked(A, offset)
        return Y, build_t_factor(Y, taus), Ared
    n1 = n // 2
    Y1, T1, A1 = panel_qr_yt(A[:, :n1], offset, panel_width)
    # Qᵀ applied to the trailing columns: A2 ← A2 + Y1 (T1ᵀ (Y1ᵀ A2))
    A2 = A[:, n1:]
    A2 = A2 + Y1 @ (T1.T @ (Y1.T @ A2))
    Y2, T2, A2r = panel_qr_yt(A2, offset + n1, panel_width)
    Y = jnp.concatenate([Y1, Y2], axis=1)
    T = _combine_t(T1, T2, Y1, Y2)
    R = jnp.concatenate([A1, A2r], axis=1)
    return Y, T, R


@highest_precision
def panel_qr_yt_lapack(
    A: jnp.ndarray, panel_width: int = 16
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Compact-WY factors from the backend's native (geqrf-style) QR.

    ``jnp.linalg.qr(mode="raw")`` runs XLA's blocked Householder QR — O(1)
    trace size in the width and LAPACK-grade runtime — and its reflector/tau
    conventions match ours exactly (verified: Q = I + Y·(−T_std)·Yᵀ).  The
    triangular factor is rebuilt per ``panel_width`` columns and merged with
    the standard two-block recurrence in log-depth.
    """
    m, n = A.shape
    h, taus = jnp.linalg.qr(A, mode="raw")
    ht = h.T  # [m, n]
    Y = jnp.tril(ht, -1) + jnp.eye(m, n, dtype=A.dtype)
    R = jnp.concatenate(
        [jnp.triu(ht[:n]), jnp.zeros((m - n, n), A.dtype)], axis=0
    ) if m >= n else jnp.triu(ht)[:m]

    def build(lo: int, hi: int) -> jnp.ndarray:
        if hi - lo <= panel_width:
            return build_t_factor(Y[:, lo:hi], taus[lo:hi])
        mid = (lo + hi) // 2
        return _combine_t(
            build(lo, mid), build(mid, hi), Y[:, lo:mid], Y[:, mid:hi]
        )

    return Y, build(0, n), R


_COLPIV_UNROLL_MAX = 48


@highest_precision
def colpiv_householder_qr(
    A: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Column-pivoted Householder QR (Eigen ColPivHouseholderQR analog).

    Greedy max-trailing-norm pivoting with static shapes: the pivot search and
    column swap are argmax + gather, so the whole routine jits and vmaps.
    Returns (Y, taus, R, perm) with ``A[:, perm] = Q R`` (perm[j] = original
    index of the j-th pivot, i.e. Eigen's colsPermutation().indices()).

    Landscape input (m < n) runs only the min(m, n) meaningful elimination
    steps (like geqrf): Y/taus have min(m, n) columns and ``R`` is the wide
    upper trapezoid; the pivot search still ranks ALL columns, so the first
    m pivots are the rank-revealing choice among the full width.

    Width guard: up to ``_COLPIV_UNROLL_MAX`` columns the loop unrolls at
    trace time (fastest for the small panels this library lives on); wider
    panels switch to a ``lax.scan`` body so trace/compile size stays O(1) in
    the width instead of O(n).
    """
    m, n = A.shape
    if n > _COLPIV_UNROLL_MAX:
        return _colpiv_householder_qr_scan(A)
    dt = A.dtype
    perm = jnp.arange(n)
    cols = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    norms2 = jnp.sum(A * A, axis=0)
    ys, taus = [], []
    for j in range(min(m, n)):
        masked = jnp.where(cols >= j, norms2, jnp.full((), -jnp.inf, dt))
        p = jnp.argmax(masked)
        # swap columns j <-> p (j static, p traced)
        swap = jnp.where(cols == j, p, jnp.where(cols == p, j, cols))
        A = A[:, swap]
        perm = perm[swap]
        norms2 = norms2[swap]
        A, v, tau = _householder_column(A, j, 0)
        # downdate trailing column norms by the freshly formed R row j
        rj = jnp.where(cols > j, A[j, :], jnp.zeros((), dt))
        norms2 = norms2 - rj * rj
        norms2 = jnp.maximum(norms2, jnp.zeros((), dt))
        ys.append(v)
        taus.append(tau)
    Y = jnp.stack(ys, axis=1) if ys else jnp.zeros((m, 0), dt)
    tau_vec = jnp.stack(taus) if taus else jnp.zeros((0,), dt)
    return Y, tau_vec, A, perm


@highest_precision
def _colpiv_householder_qr_scan(A: jnp.ndarray):
    """lax.scan body of the column-pivoted QR — one compiled step for any
    width (the unrolled loop above, with the step index traced)."""
    m, n = A.shape
    dt = A.dtype
    cols = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    rows = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)

    def body(carry, j):
        A, perm, norms2 = carry
        masked = jnp.where(cols >= j, norms2, jnp.full((), -jnp.inf, dt))
        p = jnp.argmax(masked)
        swap = jnp.where(cols == j, p, jnp.where(cols == p, j, cols))
        A = A[:, swap]
        perm = perm[swap]
        norms2 = norms2[swap]
        # _householder_column with a traced pivot index
        col = jnp.take(A, j, axis=1)
        tail_mask = rows > j
        x0 = jnp.take(col, j)
        tail = jnp.where(tail_mask, col, jnp.zeros((), dt))
        sigma = jnp.sum(tail * tail)
        norm = jnp.sqrt(x0 * x0 + sigma)
        sign = jnp.where(x0 >= 0, jnp.ones((), dt), -jnp.ones((), dt))
        beta = -sign * norm
        degenerate = sigma <= jnp.zeros((), dt)
        safe_denom = jnp.where(degenerate, jnp.ones((), dt), x0 - beta)
        v = jnp.where(tail_mask, col / safe_denom, jnp.zeros((), dt))
        v = jnp.where(rows == j, jnp.ones((), dt), v)
        safe_beta = jnp.where(norm == 0, jnp.ones((), dt), beta)
        tau = jnp.where(degenerate, jnp.zeros((), dt), (beta - x0) / safe_beta)
        w = tau * (v @ A)
        A = A - jnp.outer(v, w)
        rj = jnp.where(cols > j, jnp.take(A, j, axis=0), jnp.zeros((), dt))
        norms2 = jnp.maximum(norms2 - rj * rj, jnp.zeros((), dt))
        return (A, perm, norms2), (v, tau)

    init = (A, jnp.arange(n), jnp.sum(A * A, axis=0))
    (A, perm, _), (Yt, taus) = jax.lax.scan(
        body, init, jnp.arange(min(m, n), dtype=jnp.int32)
    )
    return Yt.T, taus, A, perm


@highest_precision
def apply_wy(
    Y: jnp.ndarray, T: jnp.ndarray, M: jnp.ndarray, transpose: bool = False
) -> jnp.ndarray:
    """``Q M`` (or ``Qᵀ M``) for one compact-WY block: M + Y ((T or Tᵀ) (Yᵀ M))."""
    Tt = T.T if transpose else T
    return M + Y @ (Tt @ (Y.T @ M))


@highest_precision
def form_q(Y: jnp.ndarray, T: jnp.ndarray) -> jnp.ndarray:
    """Explicit dense Q = I + Y T Yᵀ  [m, m]."""
    m = Y.shape[0]
    return jnp.eye(m, dtype=Y.dtype) + Y @ (T @ Y.T)


@functools.partial(jax.jit, static_argnames=("panel_width",))
def batched_panel_qr_yt(blocks: jnp.ndarray, panel_width: int = 16):
    """vmap of :func:`panel_qr_yt` over a [nb, m, n] block batch."""
    return jax.vmap(lambda a: panel_qr_yt(a, 0, panel_width))(blocks)


@highest_precision
def panel_qr_yt_soa(A: jnp.ndarray):
    """Batched unblocked Householder QR on a lane-major SoA batch.

    ``A`` is ``[m, n, B]`` — the batch axis LAST (minor), so every
    per-batch scalar of the recurrence (norms, taus, pivots) is a full
    vector over the batch and column ops run on dense ``[m, B]`` tiles.

    Conventions match :func:`householder_qr_unblocked` +
    :func:`build_t_factor` exactly (v[j] = 1, tau = 0 on degenerate
    columns, ``Q = I + Y T Yᵀ`` with the negated-T convention of the
    reference, BandedBlockedSparseQR.h:476-477); offset is fixed at 0.
    ``n`` must be small (the loop unrolls; CAQR slabs have n = 2·overlap).

    Returns ``(Y [m, n, B], T [n, n, B], R_top [n, n, B])`` where R_top is
    the leading n rows of the reduced matrix (upper-triangular part = R).
    All contractions are written as broadcast-multiply + axis-sum so XLA
    lowers them to elementwise/reduce ops over the batch axis — no
    dot_general that could force a relayout of the SoA operands.
    """
    m, n, B = A.shape
    dt = A.dtype
    one = jnp.ones((), dt)
    zero = jnp.zeros((), dt)
    rows = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    ys, taus = [], []
    for j in range(n):
        col = A[:, j]  # [m, B]
        tail_mask = (rows > j)[:, None]
        x0 = col[j]  # [B]
        tail = jnp.where(tail_mask, col, zero)
        sigma = jnp.sum(tail * tail, axis=0)
        norm = jnp.sqrt(x0 * x0 + sigma)
        sign = jnp.where(x0 >= 0, one, -one)
        beta = -sign * norm
        degenerate = sigma <= zero
        safe_denom = jnp.where(degenerate, one, x0 - beta)
        v = jnp.where(tail_mask, col / safe_denom, zero)
        v = v.at[j].set(one)
        safe_beta = jnp.where(norm == 0, one, beta)
        tau = jnp.where(degenerate, zero, (beta - x0) / safe_beta)
        # H A = A - tau v (vᵀ A); processed columns c < j have zero tails
        # below row j, so the full-width update is a no-op on them (same
        # argument as _householder_column)
        w = tau[None, :] * jnp.sum(v[:, None, :] * A, axis=0)  # [n, B]
        A = A - v[:, None, :] * w[None, :, :]
        ys.append(v)
        taus.append(tau)
    Y = jnp.stack(ys, axis=1)  # [m, n, B]
    T = jnp.zeros((n, n, B), dt)
    for j in range(n):
        tau = taus[j]
        if j > 0:
            z = jnp.sum(Y[:, :j] * Y[:, j][:, None, :], axis=0)  # [j, B]
            Tz = jnp.sum(T[:j, :j] * z[None, :, :], axis=1)  # [j, B]
            T = T.at[:j, j].set(-tau[None, :] * Tz)
        T = T.at[j, j].set(tau)
    return Y, -T, A[:n]


@highest_precision
def rank_masked_triangular_solve(
    R: jnp.ndarray, y: jnp.ndarray, k: jnp.ndarray
) -> jnp.ndarray:
    """Basic-solution triangular solve of rank ``k`` (traced scalar).

    For a *column-pivoted* R the dead pivots cluster at the tail, so the
    leading k×k block is the nonsingular part: rows/cols >= k are masked to
    identity, the RHS tail is zeroed, and x[k:] = 0.  This is exactly Eigen
    ColPivHouseholderQR's basic least-squares solution
    (/root/reference/test/test-qrkit.cpp uses it via the block solvers) with
    XLA-static shapes — the rank enters only through masks.
    """
    n = R.shape[0]
    i = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    live = (i[:, None] < k) & (i[None, :] < k)
    U = jnp.where(live, R, jnp.eye(n, dtype=R.dtype))
    rhs = jnp.where(i < k, y, jnp.zeros((), y.dtype))
    x = jax.lax.linalg.triangular_solve(
        U, rhs[:, None], left_side=True, lower=False
    )[:, 0]
    return jnp.where(i < k, x, jnp.zeros((), x.dtype))


def rank_from_diag(d: jnp.ndarray, m: int, n: int) -> jnp.ndarray:
    """Numerical rank from |diag(R)| with Eigen's ColPiv-style threshold
    (eps * max(m, n) * maxpivot)."""
    d = jnp.abs(d)
    tol = jnp.max(d, initial=jnp.zeros((), d.dtype)) * (
        max(m, n) * jnp.finfo(d.dtype).eps
    )
    return jnp.sum(d > tol)
