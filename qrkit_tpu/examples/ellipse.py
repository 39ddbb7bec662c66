"""Ellipse fitting with latent correspondences — the reference's flagship demo.

Accelerator re-implementation of /root/reference/examples/ellipse_fitting.cpp and
the benchmark driver bench/bench_sparse_qr_extra.cpp: fit (a, b, x0, y0, r) plus
one latent parameter t_i per point by Levenberg–Marquardt.  The Jacobian is
block-angular: a block-diagonal left part (∂residuals_i/∂t_i, one 2x1 block per
point) and 5 dense right columns (∂/∂model params) — ellipse_fitting.cpp:116-147.

The damped system keeps the structure: interleaving each t_i damping row under
its block turns 2x1 blocks into 3x1 blocks (the pattern of test-utils.cpp:
254-274), and the 5 model-param damping rows append below.  One structure plan
serves every LM iteration, so each iteration is a fixed sequence of cache-hit
jitted calls: batched 3x1 QR (vmap), a [3N+5, 5] implicit-Q product, a
tall-skinny dense QR, and triangular solves.

Residuals and Jacobian entries are computed vectorized over all points (the
reference loops per point on the CPU, ellipse_fitting.cpp:73-109).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..containers import BlockDiagonal, BlockMatrix1x2
from ..lm import (
    LMConfig,
    LMResult,
    levenberg_marquardt,
    levenberg_marquardt_device,
    levenberg_marquardt_device_batch,
)
from ..solvers import BlockAngularQR, BlockDiagonalQR, DenseColPivQR, QFormat

__all__ = [
    "Ellipse",
    "ellipse_points",
    "EllipseFitting",
    "fit_ellipse",
    "fit_ellipse_batch",
]


@dataclasses.dataclass
class Ellipse:
    a: float = 7.5
    b: float = 2.0
    x0: float = 17.0
    y0: float = 23.0
    r: float = 0.23


def ellipse_points(el: Ellipse, npoints: int, arc: float = 1.3 * np.pi) -> np.ndarray:
    """Sample points along the ellipse (bench_sparse_qr_extra.cpp:281-292)."""
    t = np.arange(npoints) * (arc / npoints)
    x = el.x0 + el.a * np.cos(t) * np.cos(el.r) - el.b * np.sin(t) * np.sin(el.r)
    y = el.y0 + el.a * np.cos(t) * np.sin(el.r) + el.b * np.sin(t) * np.cos(el.r)
    return np.stack([x, y])  # [2, N]


@jax.jit
def _residuals(params: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """fvec[2i] = X_i - x(t_i), fvec[2i+1] = Y_i - y(t_i)  (ellipse_fitting.cpp:62-79)."""
    n = pts.shape[1]
    t = params[:n]
    a, b, x0, y0, r = params[n], params[n + 1], params[n + 2], params[n + 3], params[n + 4]
    ct, st = jnp.cos(t), jnp.sin(t)
    cr, sr = jnp.cos(r), jnp.sin(r)
    x = a * ct * cr - b * st * sr + x0
    y = a * ct * sr + b * st * cr + y0
    res = jnp.stack([pts[0] - x, pts[1] - y], axis=1)  # [N, 2]
    return res.reshape(-1)


@jax.jit
def _jacobian_blocks(params: jnp.ndarray, pts: jnp.ndarray):
    """Structured Jacobian: left 2x1 diagonal blocks [N,2,1] + dense right [2N,5]
    (ellipse_fitting.cpp:85-113)."""
    n = pts.shape[1]
    t = params[:n]
    a, b, r = params[n], params[n + 1], params[n + 4]
    ct, st = jnp.cos(t), jnp.sin(t)
    cr, sr = jnp.cos(r), jnp.sin(r)

    # d fvec / d t_i  (2x1 block per point)
    d0 = a * cr * st + b * sr * ct
    d1 = a * sr * st - b * cr * ct
    left = jnp.stack([d0, d1], axis=1)[:, :, None]  # [N, 2, 1]

    # d fvec / d (a, b, x0, y0, r)  — rows interleaved (2i, 2i+1)
    row0 = jnp.stack(
        [-ct * cr, st * sr, -jnp.ones_like(t), jnp.zeros_like(t), a * ct * sr + b * st * cr],
        axis=1,
    )
    row1 = jnp.stack(
        [-ct * sr, -st * cr, jnp.zeros_like(t), -jnp.ones_like(t), -a * ct * cr + b * st * sr],
        axis=1,
    )
    right = jnp.stack([row0, row1], axis=1).reshape(2 * n, 5)
    return left, right


@jax.jit
def _damped_system(left, right, res, lam):
    """Assemble [J; √λ I] with damping rows interleaved into the block structure.

    left [N,2,1], right [2N,5], res [2N] →
      left_d  [N,3,1]  (damping row under each block)
      right_d [3N+5,5] (zeros at damping rows; √λ I₅ at the bottom)
      rhs     [3N+5]   (-res interleaved with zeros)
    """
    n = left.shape[0]
    dt = left.dtype
    sl = jnp.sqrt(lam).astype(dt)
    damp = jnp.full((n, 1, 1), sl)
    left_d = jnp.concatenate([left, damp], axis=1)  # [N, 3, 1]

    right3 = jnp.concatenate(
        [right.reshape(n, 2, 5), jnp.zeros((n, 1, 5), dt)], axis=1
    ).reshape(3 * n, 5)
    right_d = jnp.concatenate([right3, sl * jnp.eye(5, dtype=dt)], axis=0)

    rhs3 = jnp.concatenate(
        [-res.reshape(n, 2), jnp.zeros((n, 1), dt)], axis=1
    ).reshape(3 * n)
    rhs = jnp.concatenate([rhs3, jnp.zeros((5,), dt)])
    return left_d, right_d, rhs


@jax.jit
def _residuals_soa(params: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Residuals in lane-major [2, N] form (block axis minor)."""
    n = pts.shape[1]
    t = params[:n]
    a, b, x0, y0, r = params[n], params[n + 1], params[n + 2], params[n + 3], params[n + 4]
    ct, st = jnp.cos(t), jnp.sin(t)
    cr, sr = jnp.cos(r), jnp.sin(r)
    x = a * ct * cr - b * st * sr + x0
    y = a * ct * sr + b * st * cr + y0
    return jnp.stack([pts[0] - x, pts[1] - y], axis=0)  # [2, N]


@jax.jit
def _jacobian_soa(params: jnp.ndarray, pts: jnp.ndarray):
    """Structured Jacobian in lane-major form: left [2, N] (the per-point 2×1
    block as a column over lanes), right [2, 5, N]."""
    n = pts.shape[1]
    t = params[:n]
    a, b, r = params[n], params[n + 1], params[n + 4]
    ct, st = jnp.cos(t), jnp.sin(t)
    cr, sr = jnp.cos(r), jnp.sin(r)
    left = jnp.stack([a * cr * st + b * sr * ct, a * sr * st - b * cr * ct], axis=0)
    one, zero = jnp.ones_like(t), jnp.zeros_like(t)
    row0 = jnp.stack([-ct * cr, st * sr, -one, zero, a * ct * sr + b * st * cr], axis=0)
    row1 = jnp.stack([-ct * sr, -st * cr, zero, -one, -a * ct * cr + b * st * sr], axis=0)
    return left, jnp.stack([row0, row1], axis=0)  # [2, N], [2, 5, N]


def _residuals_aux(params, pts):
    return _residuals(params, pts)


def _damped_step_aux(params, res, lam, pts):
    """Module-level damped step (hashable for the device-loop compile cache).

    Lane-major (SoA) pipeline: residuals/Jacobian recomputed in [·, N] form
    feed the SoA damped step directly (the `res` operand is ignored in favor
    of the lane-major recompute — a few elementwise ops beat a relayout)."""
    from ..functional import lm_damped_step_blockdiag1

    left, right = _jacobian_soa(params, pts)
    res_soa = _residuals_soa(params, pts)
    return lm_damped_step_blockdiag1(left, right, res_soa, lam)


def _damped_step_aux_aos(params, res, lam, pts):
    """The generic fused path (kept as a cross-check of the SoA kernel)."""
    from ..functional import block_angular_lstsq

    left, right = _jacobian_blocks(params, pts)
    left_d, right_d, rhs = _damped_system(left, right, res, lam)
    return block_angular_lstsq(left_d, right_d, rhs, n_shards=1, tail=5)


class EllipseFitting:
    """LM functor bundle: residuals + damped structured step via block-angular QR.

    ``fused=True`` (default) runs the damped step as one compiled program
    (:func:`qrkit_tpu.functional.block_angular_lstsq`); ``fused=False`` drives
    the class-based solver composition — same math, same factors, used to
    cross-check the two paths.
    """

    def __init__(self, pts: np.ndarray, dtype=jnp.float64, fused: bool = True):
        self._pts_np = np.asarray(pts)  # host copy (initial_params reads it —
        # re-fetching the device copy would cost a device->host sync)
        self.pts = jnp.asarray(pts, dtype=dtype)
        self.n = int(pts.shape[1])
        self.dtype = dtype
        self.fused = fused

    def residuals(self, params: jnp.ndarray) -> jnp.ndarray:
        return _residuals(params, self.pts)

    def damped_step(self, params: jnp.ndarray, res: jnp.ndarray, lam: float) -> jnp.ndarray:
        left, right = _jacobian_blocks(params, self.pts)
        left_d, right_d, rhs = _damped_system(
            left, right, res, jnp.asarray(lam, self.dtype)
        )
        n = self.n
        if self.fused:
            from ..functional import block_angular_lstsq

            return block_angular_lstsq(left_d, right_d, rhs, n_shards=1, tail=5)
        blk = BlockDiagonal(left_d, 3 * n + 5, n)
        solver = BlockAngularQR(
            BlockDiagonalQR(QFormat.FULL_Q, pivot=False), DenseColPivQR()
        )
        solver.compute(BlockMatrix1x2(blk, right_d))
        return solver.solve(rhs)

    def damped_step_banded(
        self, params: jnp.ndarray, res: jnp.ndarray, lam: float
    ) -> jnp.ndarray:
        """The reference's second solver stack: banded-blocked left solver
        composed with dense ColPiv right (SparseBlockBandedQR_EllipseFitting,
        examples/ellipse_fitting.cpp:149-180).  Host-side sparse construction
        per call — demonstration/parity path, not the production loop."""
        from ..solvers import BandedBlockedQR
        from ..sparse import SparseCSR

        left, right = _jacobian_blocks(params, self.pts)
        left_d, right_d, rhs = _damped_system(
            left, right, res, jnp.asarray(lam, self.dtype)
        )
        n = self.n
        left_np = np.asarray(left_d)  # [N, 3, 1]
        rows = np.arange(3 * n)
        cols = np.repeat(np.arange(n), 3)
        left_sp = SparseCSR.from_triplets(
            rows, cols, left_np.reshape(-1), (3 * n + 5, n)
        )
        solver = BlockAngularQR(
            BandedBlockedQR(block_rows=3, block_cols=1, block_overlap=0,
                            suggested_block_cols=1),
            DenseColPivQR(),
        )
        solver.compute(BlockMatrix1x2(left_sp, right_d))
        return solver.solve(rhs)

    def initial_params(self) -> jnp.ndarray:
        """ellipse_fitting.cpp:208-232: bounding-box init + uniform t spread."""
        return jnp.asarray(initial_params_np(self._pts_np), dtype=self.dtype)


def initial_params_np(pts: np.ndarray) -> np.ndarray:
    """Host-only initial guess (ellipse_fitting.cpp:208-232): bounding-box
    init + uniform t spread.  Pure NumPy so batch drivers can build B initial
    vectors without B device round trips."""
    pts = np.asarray(pts)
    n = pts.shape[1]
    params = np.zeros(n + 5)
    params[:n] = np.arange(n) * (1.3 * np.pi / n)
    params[n] = 0.5 * (pts[0].max() - pts[0].min())
    params[n + 1] = 0.5 * (pts[1].max() - pts[1].min())
    params[n + 2] = 0.5 * (pts[0].max() + pts[0].min())
    params[n + 3] = 0.5 * (pts[1].max() + pts[1].min())
    return params


def canonicalize_ellipse(params: np.ndarray, n: int) -> np.ndarray:
    """Resolve parameter ambiguities (ellipse_fitting.cpp:234-253)."""
    p = params.copy()
    if abs(p[n + 1]) > abs(p[n]):
        p[n], p[n + 1] = p[n + 1], p[n]
        p[n + 4] -= 0.5 * np.pi
    if p[n] < 0:
        p[n] *= -1.0
        p[n + 1] *= -1.0
        p[n + 4] += np.pi
    while p[n + 4] < 0:
        p[n + 4] += 2.0 * np.pi
    while p[n + 4] > np.pi:
        p[n + 4] -= np.pi
    return p


def fit_ellipse(
    pts: np.ndarray,
    config: Optional[LMConfig] = None,
    dtype=jnp.float64,
    fused: bool = True,
    loop: str = "device",
) -> Tuple[LMResult, np.ndarray]:
    """End-to-end LM ellipse fit; returns (LMResult, canonicalized params).

    ``loop="device"`` (default) runs the whole minimize as one compiled
    program (lax.while_loop); ``loop="host"`` uses the Python-driven loop.
    """
    functor = EllipseFitting(pts, dtype=dtype, fused=fused)
    cfg = config or LMConfig(max_iters=60)
    if loop == "device":
        result = levenberg_marquardt_device(
            _residuals_aux, _damped_step_aux, functor.initial_params(), cfg,
            aux=functor.pts,
        )
    else:
        result = levenberg_marquardt(
            functor.residuals, functor.damped_step, functor.initial_params(), cfg
        )
    canon = canonicalize_ellipse(np.asarray(result.x), functor.n)
    return result, canon


def fit_ellipse_batch(
    pts_batch: np.ndarray,
    config: Optional[LMConfig] = None,
    dtype=jnp.float64,
) -> LMResult:
    """Fit B independent ellipses in ONE compiled dispatch + ONE fetch.

    ``pts_batch`` is [B, 2, N].  The whole-minimize ``lax.while_loop`` is
    vmapped over the problem axis, so B fits cost two dispatches and syncs
    total instead of 2B — the throughput answer to the reference's small-N
    wall-times (its 0.005 s at N=500, bench_sparse_qr_extra.cpp / README
    table, is a per-problem serial cost; here B such fits share one
    program's launches).  Returns an :class:`LMResult` of batched arrays
    ([B, n] solutions, [B] costs/iterations/convergence flags).
    """
    pts_batch = np.asarray(pts_batch)
    x0 = np.stack([initial_params_np(p) for p in pts_batch])
    cfg = config or LMConfig(max_iters=60)
    return levenberg_marquardt_device_batch(
        _residuals_aux,
        _damped_step_aux,
        jnp.asarray(x0, dtype=dtype),
        cfg,
        aux_batch=jnp.asarray(pts_batch, dtype=dtype),
    )
