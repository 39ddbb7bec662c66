"""One-dispatch fused programs for the dense-A2 block-angular stack.

The generic :class:`~qrkit_tpu.solvers.block_angular.BlockAngularQR`
composition runs each sub-solver method as eager jax ops — measured at ~42
program executions per warm recompute and ~87 per solve on the flagship
``BlockDiagonalQR (2x1, FULL_Q, no pivot) left + dense right`` stack, each
with its own launch and host dispatch overhead, which on problems whose math
is sub-millisecond is most of the time.
These builders fuse the reference pipeline (compute steps 1-5 of
/root/reference/src/QRKit/BlockAngularSparseQR.h:458-514 and the `_solve_impl`
shape of :305-330) into ONE compiled program each for that stack; the caller
(`BlockAngularQR.compute` / `.solve`) populates the sub-solver objects from
the outputs so every other protocol method behaves exactly as the generic
path.

Applicability (checked by the caller): left is ``BlockDiagonalQR`` with
``FULL_Q``, ``pivot=False``, portrait blocks, no zero-column tail and no
mesh; right is ``DenseColPivQR`` or ``DenseHouseholderQR``; A2 is dense with
at least ``m2`` rows below the economy band.  Row tail rows (beyond
``nb*br``) pass through Q1 with identity, matching
``BlockDiagonalQR.apply_qt``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.householder import (
    apply_wy,
    build_t_factor,
    colpiv_householder_qr,
    form_q,
    highest_precision,
    panel_qr_yt,
    rank_from_diag,
    rank_masked_triangular_solve,
)
from .base import _diag_health

__all__ = [
    "fused_dense_compute",
    "fused_dense_compute_solve",
    "fused_dense_solve",
    "fused_soa_compute",
    "fused_soa_compute_solve",
    "fused_soa_solve",
]


@functools.partial(jax.jit, static_argnames=("bc", "colpiv"))
@highest_precision
def fused_dense_compute(blocks, a2, *, bc: int, colpiv: bool):
    """blocks [nb, br, bc], a2 [n1, m2] -> the whole composite factorization.

    Returns ``(Q, R, j2_top, Y2, T2, R2, perm2, r12, h1, h2)`` — exactly the
    arrays the two sub-solvers and the composite glue would have produced:
    per-block full Q/R (steps 1), Q1ᵀA2 split at the economy band (steps
    2-3), the right QR of the bottom rows, and R12 = top rows in the right
    solver's column order (step 4).  ``h1``/``h2`` are each child's own
    health scalar with its own zero-pivot semantics (the composite
    ``_set_success`` combines them exactly as on the generic path)."""
    nb, br, _ = blocks.shape
    m2 = a2.shape[1]

    # step 1: batched per-block QR (BlockDiagonalQR._factorize_blocks,
    # pivot=False), full Q
    def one(a):
        Y, T, Ared = panel_qr_yt(a)
        return form_q(Y, T), jnp.triu(Ared[:bc])

    Q, R = jax.vmap(one)(blocks)

    # steps 2-3: J2 = Q1ᵀ A2 with FULL_Q row coordinates — econ rows
    # (0..nb*bc) then complement rows then the identity pass-through tail
    body = a2[: nb * br].reshape(nb, br, m2)
    outb = jnp.einsum("bij,bik->bjk", Q, body)
    j2_top = outb[:, :bc].reshape(nb * bc, m2)
    j2_bot = jnp.concatenate(
        [outb[:, bc:].reshape(nb * (br - bc), m2), a2[nb * br :]], axis=0
    )

    if colpiv:
        Y2, taus2, R2raw, perm2 = colpiv_householder_qr(j2_bot)
        T2 = build_t_factor(Y2, taus2)
        R2 = jnp.triu(R2raw)
        h2 = _diag_health(jnp.diagonal(R2), check_zero=False)
        r12 = j2_top[:, perm2]
    else:
        Y2, T2, R2raw = panel_qr_yt(j2_bot)
        R2 = jnp.triu(R2raw)
        perm2 = jnp.arange(m2, dtype=jnp.int32)
        h2 = _diag_health(jnp.diagonal(R2), check_zero=True)
        r12 = j2_top

    h1 = _diag_health(
        jnp.diagonal(R, axis1=1, axis2=2).reshape(-1), check_zero=True
    )
    return Q, R, j2_top, Y2, T2, R2, perm2, r12, h1, h2


@functools.partial(jax.jit, static_argnames=("bc", "colpiv"))
@highest_precision
def fused_dense_solve(Q, R, Y2, T2, R2, perm2, r12, b, *, bc: int, colpiv: bool):
    """Least-squares solve against the fused factorization, one program.

    Same math as ``QRSolver.solve`` through the composite: per-block Q1ᵀb,
    right Q2ᵀ on the bottom rows, R2 back-substitution (rank-masked for the
    ColPiv right), R12 elimination, per-block R1 back-substitution, and the
    right block's column back-permutation applied on device."""
    nb, br, _ = Q.shape
    m2 = R2.shape[1]
    m1 = nb * bc
    body = b[: nb * br].reshape(nb, br)
    outb = jnp.einsum("bij,bi->bj", Q, body)
    y_top = outb[:, :bc].reshape(m1)
    y_bot = jnp.concatenate([outb[:, bc:].reshape(-1), b[nb * br :]])

    y2 = apply_wy(Y2, T2, y_bot[:, None], transpose=True)[:, 0]
    R2sq = R2[:m2, :m2]
    if colpiv:
        k = rank_from_diag(jnp.diagonal(R2sq), Y2.shape[0], m2)
        x2 = rank_masked_triangular_solve(R2sq, y2[:m2], k)
    else:
        x2 = jax.lax.linalg.triangular_solve(
            R2sq, y2[:m2, None], left_side=True, lower=False
        )[:, 0]

    rhs1 = (y_top - r12 @ x2).reshape(nb, bc, 1)
    x1 = jax.lax.linalg.triangular_solve(
        R, rhs1, left_side=True, lower=False
    ).reshape(m1)

    # composed back-permutation: left is identity (no pivot, no tail), so
    # only the right block permutes — x[m1 + perm2[i]] = x2[i]
    inv2 = jnp.zeros_like(perm2).at[perm2].set(
        jnp.arange(m2, dtype=perm2.dtype)
    )
    return jnp.concatenate([x1, x2[inv2]])


@functools.partial(
    jax.jit, static_argnames=("br", "bc", "colpiv", "aos", "a2_aos")
)
@highest_precision
def fused_soa_compute(
    a_in, a2_in, *, br: int, bc: int, colpiv: bool, aos: bool, a2_aos: bool
):
    """Lane-major twin of :func:`fused_dense_compute` — the whole five-step
    composition with the block axis minor end to end.

    Every boundary array is lane-major: blocks ``[br*bc, N]``
    (``BlockDiagonal.from_soa``), A2 transposed ``[m2, n1]``
    (``BlockMatrix1x2(right_t=True)``), and every stored factor keeps the
    block axis N minor.  ``aos``/``a2_aos`` accept the AoS layouts by
    transposing INSIDE the one program.

    Per-block Householder QR with unnormalized reflectors (the
    ``_householder_inplace`` derivation), trailing update on the per-block
    A2 rows, then a lane-major tall QR of the bottom panel — column
    pivoting (Eigen ColPivHouseholderQR order, downdated norms, matching
    :func:`~qrkit_tpu.ops.householder.colpiv_householder_qr`) runs as
    dynamic ROW swaps of the transposed panel.  Returns
    ``(U1 [bc, br, N], c1 [bc, N], R1 [bc, bc, N], j2t [bc, m2, N],
    U2 [m2, Lb], c2 [m2], R2 [m2, m2], perm2 [m2], r12t [bc, m2, N],
    health)``.
    Reference pipeline: BlockAngularSparseQR.h:458-514.
    """
    if aos:
        nb = a_in.shape[0]
        a = [
            [a_in[:, r, c] for c in range(bc)] for r in range(br)
        ]  # [br][bc] of [N]
    else:
        nb = a_in.shape[1]
        a = [[a_in[r * bc + c] for c in range(bc)] for r in range(br)]
    a2t = jnp.transpose(a2_in, (1, 0)) if a2_aos else a2_in  # [m2, n1]
    m2, n1 = a2t.shape
    dt = a2t.dtype

    # per-block A2 rows as br STRIDED SLICES [m2, N] — no transpose pass
    # putting the size-br minor axis major ([m2, N, br] -> [br, m2, N])
    Br = [
        jax.lax.slice(a2t, (0, r), (m2, nb * br - br + r + 1), (1, br))
        for r in range(br)
    ]

    one = jnp.ones((), dt)
    zero = jnp.zeros((), dt)
    u1s, c1s, r1_rows = [], [], []
    for j in range(bc):
        x0 = a[j][j]
        sigma = jnp.zeros_like(x0)
        for r in range(j + 1, br):
            sigma = sigma + a[r][j] * a[r][j]
        norm = jnp.sqrt(x0 * x0 + sigma)
        beta = jnp.where(x0 >= 0, -norm, norm)
        degen = sigma <= zero
        t = beta * (beta - x0)
        c_scale = jnp.where(degen, zero, one / jnp.where(degen, one, t))
        u = [jnp.zeros((nb,), dt)] * j + [x0 - beta] + [
            a[r][j] for r in range(j + 1, br)
        ]  # [br] of [N]
        for c in range(j + 1, bc):
            wA = u[j] * a[j][c]
            for r in range(j + 1, br):
                wA = wA + u[r] * a[r][c]
            wA = c_scale * wA
            for r in range(j, br):
                a[r][c] = a[r][c] - u[r] * wA
        wB = u[j][None, :] * Br[j]
        for r in range(j + 1, br):
            wB = wB + u[r][None, :] * Br[r]
        wB = c_scale[None, :] * wB  # [m2, N]
        for r in range(j, br):
            Br[r] = Br[r] - u[r][None, :] * wB
        diag_j = jnp.where(degen, x0, beta)
        row = [jnp.zeros((nb,), dt)] * j + [diag_j] + [
            a[j][jj] for jj in range(j + 1, bc)
        ]
        r1_rows.append(jnp.stack(row, axis=0))
        u1s.append(jnp.stack(u))
        c1s.append(c_scale)
    U1 = jnp.stack(u1s)  # [bc, br, N]
    c1 = jnp.stack(c1s)  # [bc, N]
    R1 = jnp.stack(r1_rows)  # [bc, bc, N]

    j2t = jnp.stack(Br[:bc])  # [bc, m2, N] — top rows (economy band)
    # bottom panel lane-major: complement rows (r-major, matching the
    # solve's y_bot flattening) then the pass-through tail
    X = jnp.concatenate(Br[bc:] + [a2t[:, nb * br :]], axis=1)  # [m2, Lb]
    Lb = X.shape[1]

    # lane-major tall QR of Xᵀ (rows of X are the columns being factored);
    # Eigen ColPiv order via downdated norms and dynamic row swaps
    lane = jax.lax.broadcasted_iota(jnp.int32, (Lb,), 0)
    perm2 = jnp.arange(m2, dtype=jnp.int32)
    norms2 = jnp.sum(X * X, axis=1)
    u2s, c2s = [], []
    rows_i = jax.lax.broadcasted_iota(jnp.int32, (m2,), 0)
    for j in range(m2):
        if colpiv:
            masked = jnp.where(
                rows_i >= j, norms2, jnp.full((), -jnp.inf, dt)
            )
            p = jnp.argmax(masked).astype(jnp.int32)
            swap = jnp.where(
                rows_i == j, p, jnp.where(rows_i == p, j, rows_i)
            )
            X = X[swap]
            perm2 = perm2[swap]
            norms2 = norms2[swap]
        col = X[j]
        x0 = col[j]
        tail = jnp.where(lane > j, col, zero)
        sigma = jnp.sum(tail * tail)
        norm = jnp.sqrt(x0 * x0 + sigma)
        beta = jnp.where(x0 >= 0, -norm, norm)
        degen = sigma <= zero
        t = beta * (beta - x0)
        c_scale = jnp.where(degen, zero, one / jnp.where(degen, one, t))
        u = tail.at[j].set(x0 - beta)
        w = (X @ u) * c_scale  # [m2]
        X = X - jnp.outer(w, u)
        X = X.at[j, j].set(jnp.where(degen, x0, beta))
        if colpiv:
            rj = jnp.where(rows_i > j, X[:, j], zero)
            norms2 = jnp.maximum(norms2 - rj * rj, zero)
        u2s.append(u)
        c2s.append(c_scale)
    U2 = jnp.stack(u2s)  # [m2, Lb]
    c2 = jnp.stack(c2s)  # [m2]
    R2 = jnp.triu(X[:, :m2].T)  # [m2, m2]

    r12t = jnp.take(j2t, perm2, axis=1) if colpiv else j2t
    h1 = _diag_health(
        jnp.diagonal(R1, axis1=0, axis2=1).reshape(-1), check_zero=True
    )
    h2 = _diag_health(jnp.diagonal(R2), check_zero=not colpiv)
    # combined INSIDE the program: an eager logical_and would be one extra
    # compiled-program execution per warm recompute (dispatch pin <= 1)
    return U1, c1, R1, j2t, U2, c2, R2, perm2, r12t, jnp.logical_and(h1, h2)


def _soa_solve_body(U1, c1, R1, U2, c2, R2, perm2, r12t, b, colpiv):
    """Shared solve math for the lane-major factorization (traced inline by
    :func:`fused_soa_solve` and the one-dispatch compute_solve program)."""
    bc, br, nb = U1.shape
    m2, Lb = U2.shape
    # b rows per block-row as strided slices (no [nb, br] -> [br, nb]
    # transpose; same reasoning as the compute-side Br slices)
    body = [
        jax.lax.slice(b, (r,), (nb * br - br + r + 1,), (br,))
        for r in range(br)
    ]
    for j in range(bc):
        w = U1[j, 0] * body[0]
        for r in range(1, br):
            w = w + U1[j, r] * body[r]
        w = c1[j] * w
        for r in range(br):
            body[r] = body[r] - U1[j, r] * w
    y_top = jnp.stack(body[:bc])  # [bc, N]
    y = jnp.concatenate(body[bc:] + [b[nb * br :]])  # [Lb]
    for j in range(m2):
        w = c2[j] * (U2[j] @ y)
        y = y - w * U2[j]
    y2 = y[:m2]
    if colpiv:
        k = rank_from_diag(jnp.diagonal(R2), Lb, m2)
        x2 = rank_masked_triangular_solve(R2, y2, k)
    else:
        x2 = jax.lax.linalg.triangular_solve(
            R2, y2[:, None], left_side=True, lower=False
        )[:, 0]
    rhs1 = y_top - jnp.einsum("jcn,c->jn", r12t, x2)  # [bc, N]
    x1_rows = [None] * bc
    for j in range(bc - 1, -1, -1):
        acc = rhs1[j]
        for jj in range(j + 1, bc):
            acc = acc - R1[j, jj] * x1_rows[jj]
        x1_rows[j] = acc / R1[j, j]
    if bc == 1:
        x1 = x1_rows[0]  # no interleave needed for single-column blocks
    else:
        x1 = jnp.stack(x1_rows, axis=1).reshape(-1)  # [N*bc] interleaved
    inv2 = jnp.zeros_like(perm2).at[perm2].set(
        jnp.arange(m2, dtype=perm2.dtype)
    )
    return jnp.concatenate([x1, x2[inv2]])


@functools.partial(jax.jit, static_argnames=("colpiv",))
@highest_precision
def fused_soa_solve(U1, c1, R1, U2, c2, R2, perm2, r12t, b, *, colpiv: bool):
    """Least-squares solve against the lane-major factorization, ONE
    program: per-block Q1ᵀb via the stored unnormalized reflectors, the
    tall-panel Q2ᵀ, rank-masked R2 back-substitution (ColPiv right),
    R12 elimination, per-lane R1 back-substitution, and the right block's
    column back-permutation — same math as :func:`fused_dense_solve`."""
    return _soa_solve_body(U1, c1, R1, U2, c2, R2, perm2, r12t, b, colpiv)


@functools.partial(jax.jit, static_argnames=("bc", "colpiv"))
@highest_precision
def fused_dense_compute_solve(blocks, a2, b, *, bc: int, colpiv: bool):
    """Factorize + least-squares solve as ONE compiled program — the
    per-iteration cost of an LM loop on the protocol path (each extra
    program execution is one more launch and host dispatch).  Returns
    ``(compute outputs..., x)``."""
    out = fused_dense_compute(blocks, a2, bc=bc, colpiv=colpiv)
    Q, R, j2_top, Y2, T2, R2, perm2, r12, h1, h2 = out
    x = fused_dense_solve(
        Q, R, Y2, T2, R2, perm2, r12, b, bc=bc, colpiv=colpiv
    )
    return out + (x,)


@functools.partial(
    jax.jit, static_argnames=("br", "bc", "colpiv", "aos", "a2_aos")
)
@highest_precision
def fused_soa_compute_solve(
    a_in, a2_in, b, *, br: int, bc: int, colpiv: bool, aos: bool, a2_aos: bool
):
    """Lane-major factorize + solve as ONE compiled program (see
    :func:`fused_soa_compute` / :func:`fused_dense_compute_solve`)."""
    out = fused_soa_compute(
        a_in, a2_in, br=br, bc=bc, colpiv=colpiv, aos=aos, a2_aos=a2_aos
    )
    U1, c1, R1, j2t, U2, c2, R2, perm2, r12t, h = out
    x = _soa_solve_body(U1, c1, R1, U2, c2, R2, perm2, r12t, b, colpiv)
    return out + (x,)
