"""Pure-functional fused pipelines — fully jittable end-to-end steps.

The class-based solvers (qrkit_tpu.solvers) orchestrate jitted kernels from the
host, mirroring the reference's object API.  For production serving/benchmarks
the whole factorize+solve pipeline should be ONE compiled program; this module
provides those fused entry points.  They are also the units the multi-chip
dry-run jits over a Mesh: the block axis is the data-parallel axis, and the
TSQR second stage is the only cross-chip reduction (SURVEY §2.3, §5.8).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .ops.householder import (
    build_t_factor,
    highest_precision,
    colpiv_householder_qr,
    form_q,
    panel_qr_yt,
)
from .parallel.tsqr import tsqr_apply, tsqr_factorize

__all__ = [
    "block_diagonal_factorize",
    "block_diagonal_lstsq",
    "block_angular_lstsq",
    "lm_damped_step_blockdiag",
    "lm_damped_step_blockdiag1",
]


def _blockdiag_qr(blocks, pivot: bool):
    bc = blocks.shape[2]
    if pivot:
        def one(a):
            Y, taus, Ared, perm = colpiv_householder_qr(a)
            return form_q(Y, build_t_factor(Y, taus)), jnp.triu(Ared[:bc]), perm
    else:
        def one(a):
            Y, T, Ared = panel_qr_yt(a)
            return form_q(Y, T), jnp.triu(Ared[:bc]), jnp.arange(bc)
    return jax.vmap(one)(blocks)


@functools.partial(jax.jit, static_argnames=("pivot",))
@highest_precision
def block_diagonal_factorize(blocks: jnp.ndarray, pivot: bool = False):
    """Batched QR of a [nb, br, bc] block-diagonal batch → (Q, R, perm)."""
    return _blockdiag_qr(blocks, pivot)


@highest_precision
def _block_diagonal_lstsq_primal(blocks, b, pivot: bool):
    """Shared primal: returns (x [nb*bc], R [nb,bc,bc], lperm [nb,bc])."""
    nb, br, bc = blocks.shape
    bb = b[: nb * br].reshape(nb, br, 1)
    if pivot:
        def one(a, v):
            Y, taus, Ared, perm = colpiv_householder_qr(a)
            T = build_t_factor(Y, taus)
            qtb = v + Y @ (T.T @ (Y.T @ v))
            return jnp.triu(Ared[:bc]), qtb[:bc, 0], perm
        R, y, lperm = jax.vmap(one)(blocks, bb)
    else:
        def one(a, v):
            Y, T, Ared = panel_qr_yt(a)
            qtb = v + Y @ (T.T @ (Y.T @ v))
            return jnp.triu(Ared[:bc]), qtb[:bc, 0], jnp.arange(bc)
        R, y, lperm = jax.vmap(one)(blocks, bb)
    x = jax.lax.linalg.triangular_solve(R, y[..., None], left_side=True, lower=False)[
        ..., 0
    ]
    if pivot:
        x = jax.vmap(lambda xb, p: jnp.zeros_like(xb).at[p].set(xb))(x, lperm)
    return x.reshape(nb * bc), R, lperm


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _block_diagonal_lstsq(blocks, b, pivot):
    return _block_diagonal_lstsq_primal(blocks, b, pivot)[0]


def _block_diagonal_lstsq_fwd(blocks, b, pivot):
    x, R, lperm = _block_diagonal_lstsq_primal(blocks, b, pivot)
    return x, (blocks, b, x, R, lperm)


@highest_precision
def _block_diagonal_lstsq_bwd(pivot, res, g):
    """Implicit-function-theorem VJP of x* = argmin ||Ax - b|| (full-rank A):
    with u = (AᵀA)⁻¹ḡ (two triangular solves against the saved R),
    ∂b = A u  and  ∂A = r uᵀ − (A u) x*ᵀ  with r = b − A x* — per block, so
    the whole backward pass is a handful of batched einsums at the cost of
    one extra solve, never differentiating through the factorization itself.
    """
    blocks, b, x, R, lperm = res
    nb, br, bc = blocks.shape
    gB = g.reshape(nb, bc)
    xB = x.reshape(nb, bc)
    # to permuted column order (A[:, perm] = Q R => AᵀA = S RᵀR Sᵀ)
    g_p = jnp.take_along_axis(gB, lperm, axis=1) if pivot else gB
    w = jax.lax.linalg.triangular_solve(
        R, g_p[..., None], left_side=True, lower=False, transpose_a=True
    )
    u_p = jax.lax.linalg.triangular_solve(
        R, w, left_side=True, lower=False
    )[..., 0]
    u = (
        jax.vmap(lambda ub, p: jnp.zeros_like(ub).at[p].set(ub))(u_p, lperm)
        if pivot
        else u_p
    )
    Au = jnp.einsum("bij,bj->bi", blocks, u)
    r = b[: nb * br].reshape(nb, br) - jnp.einsum("bij,bj->bi", blocks, xB)
    g_blocks = jnp.einsum("bi,bj->bij", r, u) - jnp.einsum("bi,bj->bij", Au, xB)
    g_b = jnp.zeros_like(b).at[: nb * br].set(Au.reshape(nb * br))
    return g_blocks, g_b


_block_diagonal_lstsq.defvjp(_block_diagonal_lstsq_fwd, _block_diagonal_lstsq_bwd)


@functools.partial(jax.jit, static_argnames=("pivot",))
@highest_precision
def block_diagonal_lstsq(blocks: jnp.ndarray, b: jnp.ndarray, pivot: bool = False):
    """Fused factorize + least-squares solve for a block-diagonal system.

    The flagship pipeline (BASELINE.json config 2): one compiled program doing
    batched compact-WY QR, batched Qᵀb (applied through the implicit Y/T
    factors — the [nb, br, br] explicit Q is never materialized, saving
    ~br/bc × the HBM traffic), batched triangular solve, and the pivot
    back-permutation.  ``b`` is [nb*br] (+ ignored tail rows allowed).

    Differentiable: reverse-mode AD uses an implicit-function-theorem custom
    VJP (gradients w.r.t. ``blocks`` and ``b`` via one extra pair of
    triangular solves against the already-computed R — the factorization is
    never unrolled).  Gradients assume full-rank blocks; the reference, being
    a C++ library, has no AD story at all.
    """
    return _block_diagonal_lstsq(blocks, b, pivot)


@highest_precision
def _block_angular_lstsq_primal(left_blocks, right, b, n_shards: int, tail: int):
    nb, br, bc = left_blocks.shape
    m1 = nb * bc
    m2 = right.shape[1]

    # left: batched compact-WY QR, Q kept implicit as (Y, T)
    Y1, T1, R1 = jax.vmap(lambda a: panel_qr_yt(a))(left_blocks)
    R1 = jnp.triu(R1)[:, :bc]

    # Q1ᵀ applied to [right | b] in one pass
    rb = jnp.concatenate([right, b[:, None]], axis=1)  # [nb*br + tail, m2+1]
    body = rb[: nb * br].reshape(nb, br, m2 + 1)
    qt_body = body + jnp.einsum(
        "bij,bjk->bik", Y1, jnp.einsum("bji,bjk->bik", T1, jnp.einsum("bji,bjk->bik", Y1, body))
    )
    econ = qt_body[:, :bc].reshape(nb * bc, m2 + 1)
    compl = qt_body[:, bc:].reshape(nb * (br - bc), m2 + 1)
    bottom = jnp.concatenate([compl, rb[nb * br :]], axis=0)  # [nb*(br-bc)+tail, m2+1]

    r12 = econ[:, :m2]  # J2top
    y1 = econ[:, m2]

    # right: TSQR on the bottom rows of J2
    j2bot = bottom[:, :m2]
    y_bot = bottom[:, m2]
    mbot = j2bot.shape[0]
    mloc = max(-(-mbot // n_shards), m2)
    mpad = mloc * n_shards
    j2bot = jnp.concatenate(
        [j2bot, jnp.zeros((mpad - mbot, m2), j2bot.dtype)], axis=0
    )
    y_bot = jnp.concatenate([y_bot, jnp.zeros((mpad - mbot,), y_bot.dtype)])
    Yl, Tl, Y2, T2, R2 = tsqr_factorize(j2bot, n_shards)
    z = tsqr_apply(Yl, Tl, Y2, T2, y_bot, n_shards, True)
    y2 = z[:m2]

    # back substitution: x2 then structured x1
    x2 = jax.lax.linalg.triangular_solve(R2, y2[:, None], left_side=True, lower=False)[
        :, 0
    ]
    rhs1 = (y1 - r12 @ x2).reshape(nb, bc, 1)
    x1 = jax.lax.linalg.triangular_solve(R1, rhs1, left_side=True, lower=False).reshape(
        nb * bc
    )
    return jnp.concatenate([x1, x2]), R1, r12, R2


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def _block_angular_lstsq(left_blocks, right, b, n_shards, tail):
    return _block_angular_lstsq_primal(left_blocks, right, b, n_shards, tail)[0]


def _block_angular_lstsq_fwd(left_blocks, right, b, n_shards, tail):
    x, R1, r12, R2 = _block_angular_lstsq_primal(
        left_blocks, right, b, n_shards, tail
    )
    return x, (left_blocks, right, b, x, R1, r12, R2)


@highest_precision
def _block_angular_lstsq_bwd(n_shards, tail, res, g):
    """Implicit-diff VJP through the composite [A1 | A2] least squares.

    u = (AᵀA)⁻¹ḡ via forward+back substitution on the composite
    R = [[R1, R12], [0, R2]] (all factors saved from the forward pass), then
    ∂b = A u, ∂A1 = per-block (r u1ᵀ − (Au) x1ᵀ), ∂A2 = r u2ᵀ − (Au) x2ᵀ.
    """
    left_blocks, right, b, x, R1, r12, R2 = res
    nb, br, bc = left_blocks.shape
    m1 = nb * bc
    m2 = right.shape[1]
    x1 = x[:m1].reshape(nb, bc)
    x2 = x[m1:]
    g1 = g[:m1].reshape(nb, bc)
    g2 = g[m1:]
    # Rᵀ w = g  (block forward substitution)
    w1 = jax.lax.linalg.triangular_solve(
        R1, g1[..., None], left_side=True, lower=False, transpose_a=True
    )[..., 0]
    w2 = jax.lax.linalg.triangular_solve(
        R2, (g2 - r12.T @ w1.reshape(m1))[:, None],
        left_side=True, lower=False, transpose_a=True,
    )[:, 0]
    # R u = w  (block back substitution)
    u2 = jax.lax.linalg.triangular_solve(
        R2, w2[:, None], left_side=True, lower=False
    )[:, 0]
    u1 = jax.lax.linalg.triangular_solve(
        R1, (w1.reshape(m1) - r12 @ u2).reshape(nb, bc, 1),
        left_side=True, lower=False,
    )[..., 0]
    # A u and the residual r = b - A x over all rows (incl. the tail)
    A1u = jnp.einsum("bij,bj->bi", left_blocks, u1).reshape(nb * br)
    A1x = jnp.einsum("bij,bj->bi", left_blocks, x1).reshape(nb * br)
    pad = jnp.zeros((tail,), A1u.dtype)
    Au = jnp.concatenate([A1u, pad]) + right @ u2
    r = b - (jnp.concatenate([A1x, pad]) + right @ x2)
    g_left = jnp.einsum("bi,bj->bij", r[: nb * br].reshape(nb, br), u1) - jnp.einsum(
        "bi,bj->bij", Au[: nb * br].reshape(nb, br), x1
    )
    g_right = jnp.outer(r, u2) - jnp.outer(Au, x2)
    return g_left, g_right, Au


_block_angular_lstsq.defvjp(_block_angular_lstsq_fwd, _block_angular_lstsq_bwd)


@functools.partial(jax.jit, static_argnames=("n_shards", "tail"))
@highest_precision
def block_angular_lstsq(
    left_blocks: jnp.ndarray,  # [nb, br, bc] block-diagonal A1 body
    right: jnp.ndarray,  # [nb*br + tail, m2] dense A2 (tail rows below the blocks)
    b: jnp.ndarray,  # [nb*br + tail]
    n_shards: int = 1,
    tail: int = 0,
):
    """Fused block-angular LS solve: vmapped left QR + TSQR right + block
    back-substitution — the whole damped-LM step as one compiled program.

    Sharding story: shard ``left_blocks`` (and the corresponding row-batches of
    ``right``/``b``) over the mesh's data-parallel axis; the only collective is
    the all-gather inside the TSQR second stage.

    Differentiable: reverse-mode AD runs an implicit-function-theorem custom
    VJP against the saved composite R factors (one extra forward+back
    substitution), never unrolling the QR/TSQR — gradients of the damped-LM
    step w.r.t. Jacobian blocks, the dense right block, and the RHS.
    """
    return _block_angular_lstsq(left_blocks, right, b, n_shards, tail)


def _soa_tall_qr_solve(X: jnp.ndarray, y: jnp.ndarray, m2: int):
    """LS solve of a tall-skinny system stored lane-major.

    ``X [m2, L]`` holds the tall matrix M [L, m2] TRANSPOSED (rows of M on
    the minor axis) and ``y [L]`` the RHS.  Householder QR with the pivot *lane* masked
    per step (the reflector lives along the lane axis), then the m2×m2
    triangular solve on the extracted R.  Returns x2 [m2].
    """
    dt = X.dtype
    L = X.shape[1]
    lane = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
    Xy = jnp.concatenate([X, y[None, :]], axis=0)  # [m2+1, L]
    for j in range(m2):
        col = Xy[j]
        x0 = col[j]
        tail = jnp.where(lane > j, col, jnp.zeros((), dt))
        sigma = jnp.sum(tail * tail)
        norm = jnp.sqrt(x0 * x0 + sigma)
        beta = jnp.where(x0 >= 0, -norm, norm)
        degen = sigma <= jnp.zeros((), dt)
        # unnormalized reflector u = (x0−β, tail); H = I − u uᵀ / (β(β−x0)) —
        # one reciprocal per step instead of an [L]-wide divide plus a tau
        # divide (same derivation as ops/pallas_blockdiag._householder_inplace;
        # β(β−x0) = ‖x‖² + ‖x‖·|x0| > 0, well-conditioned)
        t = beta * (beta - x0)
        c_scale = jnp.where(
            degen, jnp.zeros((), dt),
            jnp.ones((), dt) / jnp.where(degen, jnp.ones((), dt), t),
        )
        u = tail.at[j].set(x0 - beta)  # lanes < j are already zero
        w = (Xy @ u) * c_scale  # [m2+1] — reduce over lanes
        Xy = Xy - jnp.outer(w, u)
    R2 = Xy[:m2, :m2].T  # R[row, col] = Xy[col, lane=row]
    y2 = Xy[m2, :m2]
    return jax.lax.linalg.triangular_solve(
        jnp.triu(R2), y2[:, None], left_side=True, lower=False
    )[:, 0]


@jax.jit
@highest_precision
def lm_damped_step_blockdiag(
    left: jnp.ndarray,  # [bl, bc, nb] — per-point Jacobian block (lane-major)
    right: jnp.ndarray,  # [bl, m2, nb] — per-point rows of the dense right block
    res: jnp.ndarray,  # [bl, nb]
    lam: jnp.ndarray,  # scalar damping
):
    """General multi-column lane-major damped Gauss–Newton step.

    Solves ``min ‖[J; √λ·I] δ + [r; 0]‖`` for ``J = [blkdiag(left_i) | right]``
    with ``left_i`` the [bl, bc] block of point i — the flagship 7×2 family
    with angular columns.  Everything stays lane-major (block axis minor):
    bc unrolled per-lane Householder steps with trailing updates on
    the remaining block columns, right rows and RHS; lane-pivoted Householder
    QR of the skinny bottom panel; per-lane bc×bc back-substitution.  Damping
    rows are analytic: √λ·I_bc under each block (the reference's 7×2 → 9×2
    LM-damping pattern, test-utils.cpp:254-274) and √λ·I_m2 at the tail.

    Returns ``(x1 [bc, nb], x2 [m2])`` — x1 stays lane-major; interleave with
    ``x1.T.reshape(-1)`` only if an AoS vector is genuinely needed.
    """
    bl, bc, nb = left.shape
    m2 = right.shape[1]
    dt = left.dtype
    sl = jnp.sqrt(lam).astype(dt)

    # damped block per lane: a [br, bc, nb], br = bl + bc, damping rows √λ·I_bc
    eye_damp = jnp.broadcast_to(
        (sl * jnp.eye(bc, dtype=dt))[:, :, None], (bc, bc, nb)
    )
    a = jnp.concatenate([left, eye_damp], axis=0)
    B = jnp.concatenate(
        [
            jnp.concatenate([right, -res[:, None, :]], axis=1),
            jnp.zeros((bc, m2 + 1, nb), dt),
        ],
        axis=0,
    )  # [br, m2+1, nb]
    br = bl + bc

    r1_rows = []  # per-lane rows of the bc×bc R₁ (diag from beta)
    for j in range(bc):
        colj = a[:, j]  # [br, nb]
        x0 = colj[j]
        sigma = jnp.sum(colj[j + 1 :] * colj[j + 1 :], axis=0)
        norm = jnp.sqrt(x0 * x0 + sigma)
        beta = jnp.where(x0 >= 0, -norm, norm)
        degen = sigma <= jnp.zeros((), dt)
        # unnormalized reflector u = (x0−β, colj[j+1:]); H = I − u uᵀ/(β(β−x0))
        # — one reciprocal per column instead of a [br−j, nb] divide pass plus
        # a tau divide (ops/pallas_blockdiag._householder_inplace derivation;
        # β(β−x0) = ‖x‖² + ‖x‖·|x0| > 0 away from the degenerate branch)
        t = beta * (beta - x0)
        c_scale = jnp.where(
            degen, jnp.zeros((), dt),
            jnp.ones((), dt) / jnp.where(degen, jnp.ones((), dt), t),
        )
        u = jnp.concatenate(
            [jnp.zeros((j, nb), dt), (x0 - beta)[None], colj[j + 1 :]],
            axis=0,
        )  # [br, nb]
        # trailing update on block columns j+1.. and on [right | rhs]
        if j + 1 < bc:
            wA = c_scale[None] * jnp.einsum("rn,rcn->cn", u, a[:, j + 1 :])
            a = a.at[:, j + 1 :].add(-u[:, None, :] * wA[None])
        wB = c_scale[None] * jnp.einsum("rn,rcn->cn", u, B)
        B = B - u[:, None, :] * wB[None]
        # R₁ row j: diag = beta (or x0 when degenerate), off-diag from updated a
        diag_j = jnp.where(degen, x0, beta)
        row = [jnp.zeros((nb,), dt)] * j + [diag_j] + [
            a[j, jj] for jj in range(j + 1, bc)
        ]
        r1_rows.append(jnp.stack(row, axis=0))  # [bc, nb]
    R1 = jnp.stack(r1_rows, axis=0)  # [bc, bc, nb]

    y1 = B[:bc, m2]  # [bc, nb]
    r12 = B[:bc, :m2]  # [bc, m2, nb]

    # bottom panel: complement rows + √λ·I_m2 tail, lane-major
    comp = jnp.transpose(B[bc:], (1, 0, 2)).reshape(m2 + 1, (br - bc) * nb)
    tail = jnp.concatenate(
        [sl * jnp.eye(m2, dtype=dt), jnp.zeros((1, m2), dt)], axis=0
    )
    Xy = jnp.concatenate([comp, tail], axis=1)
    x2 = _soa_tall_qr_solve(Xy[:m2], Xy[m2], m2)

    # per-lane bc×bc back-substitution through R₁
    rhs1 = y1 - jnp.einsum("jcn,c->jn", r12, x2)  # [bc, nb]
    x1_rows = [None] * bc
    for j in range(bc - 1, -1, -1):
        acc = rhs1[j]
        for jj in range(j + 1, bc):
            acc = acc - R1[j, jj] * x1_rows[jj]
        x1_rows[j] = acc / R1[j, j]
    x1 = jnp.stack(x1_rows, axis=0)  # [bc, nb]
    return x1, x2


@jax.jit
@highest_precision
def lm_damped_step_blockdiag1(
    left: jnp.ndarray,  # [bl, nb] — per-point Jacobian column (block i = left[:, i])
    right: jnp.ndarray,  # [bl, m2, nb] — per-point rows of the dense right block
    res: jnp.ndarray,  # [bl, nb] — per-point residuals
    lam: jnp.ndarray,  # scalar damping
) -> jnp.ndarray:
    """Single-column (bc = 1) lane-major damped LM step — thin wrapper over
    :func:`lm_damped_step_blockdiag` returning the flat ``[nb + m2]`` delta the
    LM drivers consume (one [nb]-row concat: x1 has a single row)."""
    x1, x2 = lm_damped_step_blockdiag(left[:, None, :], right, res, lam)
    return jnp.concatenate([x1[0], x2])
