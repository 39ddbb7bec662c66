"""Levenberg–Marquardt driver over structured QR solvers.

The reference drives its solvers through Eigen's unsupported
``LevenbergMarquardt`` + ``SparseFunctor`` (examples/ellipse_fitting.cpp:255-270,
bench/bench_sparse_qr_extra.cpp:332-341).  This driver keeps the same shape —
residual functor + structured-Jacobian functor + a QR solve per iteration — but
solves the damped normal equations the structure-preserving way: the step
minimizes ``||[J; √λ·D] δ + [r; 0]||``, where the damping rows are row-permuted
into the Jacobian's block structure (the pattern validated by the reference's
own test, test-utils.cpp:254-274 — damping a 7x2 block-diagonal Jacobian yields
9x2 blocks), so one static structure plan serves every iteration and every
λ value: factorization stays a cache-hit jitted call.

λ adaptation follows Madsen–Nielsen (gain-ratio) — host-side control flow, as
iteration acceptance is inherently data-dependent.
"""
from __future__ import annotations

import dataclasses
import functools as _functools
from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp

__all__ = [
    "LMConfig",
    "LMResult",
    "predicted_reduction",
    "levenberg_marquardt",
    "levenberg_marquardt_device",
    "levenberg_marquardt_device_batch",
]


def predicted_reduction(delta, g, lam):
    """Madsen–Nielsen predicted cost reduction of the damped LM step:
    ``0.5 δᵀ(λδ − g)`` with gradient ``g = Jᵀr``.  For the exact damped
    minimizer this equals the Gauss–Newton model reduction
    ``0.5(‖r‖² − ‖r + Jδ‖²)``, so the gain ratio is exactly 1 on a problem
    with linear residuals."""
    return 0.5 * (
        lam * jnp.vdot(delta, delta).real - jnp.vdot(delta, g).real
    )


@dataclasses.dataclass
class LMConfig:
    max_iters: int = 100
    ftol: float = 1e-10
    xtol: float = 1e-10
    gtol: float = 1e-12
    lambda_init: float = 1e-3
    lambda_min: float = 1e-12
    lambda_max: float = 1e10


class LMResult(NamedTuple):
    x: jnp.ndarray
    cost: float
    iterations: int
    converged: bool
    lambda_final: float


def levenberg_marquardt(
    residual_fn: Callable[[jnp.ndarray], jnp.ndarray],
    damped_step_fn: Callable[[jnp.ndarray, jnp.ndarray, float], jnp.ndarray],
    x0: jnp.ndarray,
    config: Optional[LMConfig] = None,
) -> LMResult:
    """Generic LM loop.

    ``damped_step_fn(x, r, lam)`` must return the least-squares minimizer of
    ``||J(x) δ + r||² + lam ||δ||²`` — typically by a structured QR of the
    damped Jacobian (see qrkit_tpu.examples.ellipse for the canonical setup).
    """
    import jax

    cfg = config or LMConfig()
    x = jnp.asarray(x0)
    r = residual_fn(x)
    cost = float(0.5 * jnp.vdot(r, r).real)
    lam = cfg.lambda_init
    nu = 2.0
    converged = False
    it = 0
    g = None  # Jᵀr at the CURRENT (x, r): cached across rejected steps
    vjp_ok = True  # residual_fn may be host/NumPy code (not differentiable)
    for it in range(1, cfg.max_iters + 1):
        delta = damped_step_fn(x, r, lam)
        x_new = x + delta
        r_new = residual_fn(x_new)
        cost_new = float(0.5 * jnp.vdot(r_new, r_new).real)
        # Madsen–Nielsen gain ratio: predicted = 0.5 δᵀ(λδ − g), g = Jᵀr
        # (for the exact damped minimizer this equals the Gauss–Newton model
        # reduction; g comes from one VJP of the residual function, computed
        # only when (x, r) changed).  Non-traceable residual functions fall
        # back to the damping-only model (over-estimates rho but acceptance
        # is still guarded by the monotonic cost check).
        if g is None and vjp_ok:
            try:
                g = jax.vjp(residual_fn, x)[1](r)[0]
            except Exception:
                vjp_ok = False
        if g is not None:
            predicted = max(float(predicted_reduction(delta, g, lam)), 1e-300)
        else:
            predicted = max(0.5 * lam * float(jnp.vdot(delta, delta).real), 1e-300)
        rho = (cost - cost_new) / predicted

        if cost_new < cost:
            # accept
            step_small = float(jnp.linalg.norm(delta)) <= cfg.xtol * (
                float(jnp.linalg.norm(x)) + cfg.xtol
            )
            cost_red_small = (cost - cost_new) <= cfg.ftol * max(cost, 1e-300)
            x, r, cost = x_new, r_new, cost_new
            g = None  # (x, r) changed: recompute the gradient next iteration
            lam = max(lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3), cfg.lambda_min)
            nu = 2.0
            if step_small or cost_red_small:
                converged = True
                break
        else:
            lam = min(lam * nu, cfg.lambda_max)
            nu = min(nu * 2.0, 64.0)
            if lam >= cfg.lambda_max:
                break
    return LMResult(x, cost, it, converged, lam)


def _cfg_key(cfg: LMConfig):
    return (
        cfg.max_iters, cfg.ftol, cfg.xtol, cfg.gtol,
        cfg.lambda_init, cfg.lambda_min, cfg.lambda_max,
    )


def _make_minimize(residual_fn, damped_step_fn, cfg):
    """The raw whole-minimize function (shared by the jitted single-problem
    and vmapped-batch builders)."""
    import jax

    def _minimize(x0, aux):
        dt = x0.dtype
        r0 = residual_fn(x0, aux)
        cost0 = 0.5 * jnp.vdot(r0, r0).real.astype(dt)

        def cond(state):
            _, _, _, _, _, it, done = state
            return jnp.logical_and(it < cfg.max_iters, jnp.logical_not(done))

        def body(state):
            x, r, cost, lam, nu, it, done = state
            delta = damped_step_fn(x, r, lam, aux)
            x_new = x + delta
            r_new = residual_fn(x_new, aux)
            cost_new = 0.5 * jnp.vdot(r_new, r_new).real.astype(dt)
            accept = cost_new < cost

            # Madsen–Nielsen predicted reduction 0.5 δᵀ(λδ − g), g = Jᵀr via VJP
            g = jax.vjp(lambda xx: residual_fn(xx, aux), x)[1](r)[0]
            dn = jnp.vdot(delta, delta).real.astype(dt)
            predicted = jnp.maximum(
                predicted_reduction(delta, g, lam).astype(dt),
                jnp.asarray(1e-30, dt),
            )
            rho = (cost - cost_new) / predicted
            shrink = jnp.maximum(
                jnp.asarray(1.0 / 3.0, dt), 1.0 - (2.0 * rho - 1.0) ** 3
            )
            lam_acc = jnp.maximum(lam * shrink, jnp.asarray(cfg.lambda_min, dt))
            lam_rej = jnp.minimum(lam * nu, jnp.asarray(cfg.lambda_max, dt))
            lam_new = jnp.where(accept, lam_acc, lam_rej)
            nu_new = jnp.where(
                accept, jnp.asarray(2.0, dt), jnp.minimum(nu * 2.0, jnp.asarray(64.0, dt))
            )

            step_small = jnp.sqrt(dn) <= cfg.xtol * (
                jnp.linalg.norm(x) + jnp.asarray(cfg.xtol, dt)
            )
            cost_small = (cost - cost_new) <= cfg.ftol * jnp.maximum(
                cost, jnp.asarray(1e-30, dt)
            )
            done_new = jnp.where(
                accept,
                jnp.logical_or(step_small, cost_small),
                lam_rej >= jnp.asarray(cfg.lambda_max, dt),
            )

            x_out = jnp.where(accept, x_new, x)
            r_out = jnp.where(accept, r_new, r)
            cost_out = jnp.where(accept, cost_new, cost)
            return (x_out, r_out, cost_out, lam_new, nu_new, it + 1, done_new)

        init = (
            x0,
            r0,
            cost0,
            jnp.asarray(cfg.lambda_init, dt),
            jnp.asarray(2.0, dt),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
        )
        return jax.lax.while_loop(cond, body, init)

    return _minimize


@_functools.lru_cache(maxsize=64)
def _build_device_minimize(residual_fn, damped_step_fn, cfg_tuple):
    import jax

    cfg = LMConfig(*cfg_tuple)
    from .ops.householder import highest_precision

    # full-precision matmuls for the whole loop body (cost, gradient, the
    # step): a float32 product outside the scope runs in TF32 on the card
    return jax.jit(highest_precision(_make_minimize(residual_fn, damped_step_fn, cfg)))


@_functools.lru_cache(maxsize=64)
def _build_device_minimize_batch(residual_fn, damped_step_fn, cfg_tuple):
    import jax

    cfg = LMConfig(*cfg_tuple)
    from .ops.householder import highest_precision

    return jax.jit(
        highest_precision(jax.vmap(_make_minimize(residual_fn, damped_step_fn, cfg)))
    )


def levenberg_marquardt_device(
    residual_fn: Callable,
    damped_step_fn: Callable,
    x0: jnp.ndarray,
    config: Optional[LMConfig] = None,
    aux=None,
) -> LMResult:
    """Whole-minimize-on-device LM: ONE compiled program.

    The host-loop variant pays a dispatch and host sync per jitted call per
    iteration, which dominates small problems.  Here the
    full minimize (damped step, acceptance test, lambda adaptation, convergence
    checks) is a ``lax.while_loop``.  Signatures differ from the host loop so
    the compiled program caches across problem instances:
    ``residual_fn(x, aux)`` and ``damped_step_fn(x, r, lam, aux)`` must be
    module-level (hashable) traceable callables; per-problem data (points,
    measurements, ...) travels through ``aux`` as a traced operand.

    The reference has no analog (Eigen LM is a host loop) — this is the
    "train loop as one XLA program" form.
    """
    import jax

    cfg = config or LMConfig()
    fn = _build_device_minimize(residual_fn, damped_step_fn, _cfg_key(cfg))
    x, r, cost, lam, nu, it, done = fn(jnp.asarray(x0), aux)
    # ONE device->host fetch for everything (each separate float()/int() is
    # its own device->host sync)
    x_h, cost_h, lam_h, it_h, done_h = jax.device_get((x, cost, lam, it, done))
    return LMResult(x_h, float(cost_h), int(it_h), bool(done_h), float(lam_h))


def levenberg_marquardt_device_batch(
    residual_fn: Callable,
    damped_step_fn: Callable,
    x0_batch: jnp.ndarray,
    config: Optional[LMConfig] = None,
    aux_batch=None,
) -> LMResult:
    """Batched whole-minimize-on-device LM: B independent fits as ONE program.

    ``jax.vmap`` over the full :func:`levenberg_marquardt_device` while-loop —
    the throughput answer to many small fits: a single N=500 fit is bound by
    launch and dispatch overhead, but B fits amortize the same dispatches,
    and every kernel sees a B-times-wider batch.  The batched loop
    iterates while ANY problem is unconverged (finished lanes hold their
    state), so each lane's trajectory is identical to a solo run.

    ``x0_batch`` is [B, n] (``aux_batch`` [B, ...]); returns an
    :class:`LMResult` of batched arrays: ``x [B, n]``, ``cost [B]``,
    ``iterations [B]``, ``converged [B]``, ``lambda_final [B]``.

    The reference has no analog — its LM is a host loop around one problem
    (bench_sparse_qr_extra.cpp:332-341)."""
    import jax

    cfg = config or LMConfig()
    fn = _build_device_minimize_batch(residual_fn, damped_step_fn, _cfg_key(cfg))
    x, r, cost, lam, nu, it, done = fn(jnp.asarray(x0_batch), aux_batch)
    x_h, cost_h, lam_h, it_h, done_h = jax.device_get((x, cost, lam, it, done))
    return LMResult(x_h, cost_h, it_h, done_h, lam_h)
