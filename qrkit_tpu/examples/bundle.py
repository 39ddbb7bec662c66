"""Bundle adjustment — the Jacobian family the reference was built for.

QRKit's stated domain is "the Jacobians that arise in computer-vision
nonlinear least squares (bundle-adjustment-like problems solved with
Levenberg-Marquardt)" (/root/reference/README.md:3-6, arXiv 1802.03773).  The
reference ships only the ellipse demo; this example exercises the same solver
composition on the real thing:

* Parameters: P 3D points (3 each) and C cameras (axis-angle rotation +
  translation, 6 each); observations are pinhole projections of every point in
  every camera.
* Rows grouped by point make the point columns **block-diagonal**
  ([2C, 3] per point; damping rows interleave to [2C+3, 3] — the pattern of
  test-utils.cpp:254-274) and the camera columns a thin shared right block
  that is itself **sparse** (an observation row touches one camera's 6
  columns).
* The damped step is therefore
  ``BlockAngularQR(BlockDiagonalQR(), DenseColPivQR())`` over
  ``[BlockDiagonal | SparseCSR]`` — the vmapped batched point QR, the
  sparse-A2 path keeps the camera block in O(nnz), and the ColPiv
  right solver absorbs the gauge freedom (a free similarity transform makes
  the undamped camera block rank-deficient; ColPiv reports it via ``rank()``
  instead of failing).

Residuals/Jacobians are vectorized over all observations with ``vmap`` +
``jacfwd`` — no per-observation host loop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..containers import BlockDiagonal, BlockMatrix1x2
from ..lm import LMConfig, LMResult, levenberg_marquardt, levenberg_marquardt_device
from ..ops.householder import highest_precision
from ..solvers import BlockAngularQR, BlockDiagonalQR, DenseColPivQR
from ..sparse import SparseCSR

__all__ = ["make_scene", "residuals", "fit_bundle", "fit_bundle_device"]


def _rodrigues(w: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle [3] -> rotation matrix [3, 3], smooth at w = 0."""
    th2 = w @ w
    th = jnp.sqrt(th2 + 1e-30)
    a = jnp.where(th2 < 1e-16, 1.0 - th2 / 6.0, jnp.sin(th) / th)
    b = jnp.where(th2 < 1e-16, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / (th2 + 1e-30))
    K = jnp.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]], w.dtype
    )
    return jnp.eye(3, dtype=w.dtype) + a * K + b * (K @ K)


def _project(cam: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Pinhole projection (f = 1) of world point X by camera (omega, t)."""
    p = _rodrigues(cam[:3]) @ X + cam[3:]
    return p[:2] / p[2]


def make_scene(
    n_cams: int = 3, n_pts: int = 32, noise: float = 0.0, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic scene: a unit point cloud at the origin, cameras ~6 units in
    front looking roughly down +z.  Returns (cams [C,6], pts [P,3],
    uv [P,C,2])."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n_pts, 3))
    cams = np.concatenate(
        [
            0.1 * rng.normal(size=(n_cams, 3)),
            np.stack(
                [
                    0.4 * rng.normal(size=n_cams),
                    0.4 * rng.normal(size=n_cams),
                    6.0 + 0.3 * rng.normal(size=n_cams),
                ],
                axis=1,
            ),
        ],
        axis=1,
    )
    with jax.default_matmul_precision("highest"):
        proj = jax.vmap(
            lambda X: jax.vmap(lambda c: _project(c, X))(jnp.asarray(cams))
        )(jnp.asarray(pts))
    uv = np.asarray(proj) + noise * rng.normal(size=proj.shape)
    return cams, pts, uv


def _split(x: jnp.ndarray, n_pts: int, n_cams: int):
    pts = x[: 3 * n_pts].reshape(n_pts, 3)
    cams = x[3 * n_pts :].reshape(n_cams, 6)
    return pts, cams


@jax.jit
@highest_precision
def residuals(x: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Reprojection residuals, point-major then camera then (u, v) — the row
    order that makes the point columns block-diagonal."""
    n_pts, n_cams = uv.shape[0], uv.shape[1]
    pts, cams = _split(x, n_pts, n_cams)
    proj = jax.vmap(lambda X: jax.vmap(lambda c: _project(c, X))(cams))(pts)
    return (proj - uv).reshape(-1)


@jax.jit
@highest_precision
def _jacobian_blocks(x: jnp.ndarray, uv: jnp.ndarray):
    """Structured Jacobian via forward-mode AD over observations:
    J_pt [P, 2C, 3] (the block-diagonal batch) and J_cam [P, C, 2, 6]."""
    n_pts, n_cams = uv.shape[0], uv.shape[1]
    pts, cams = _split(x, n_pts, n_cams)

    def obs(c, X):
        return _project(c, X)

    jp = jax.vmap(lambda X: jax.vmap(lambda c: jax.jacfwd(obs, argnums=1)(c, X))(cams))(
        pts
    )  # [P, C, 2, 3]
    jc = jax.vmap(lambda X: jax.vmap(lambda c: jax.jacfwd(obs, argnums=0)(c, X))(cams))(
        pts
    )  # [P, C, 2, 6]
    return jp.reshape(n_pts, 2 * n_cams, 3), jc


import functools


@functools.partial(jax.jit, static_argnames=("n_cams",))
def _damped_left_rhs(jp: jnp.ndarray, res: jnp.ndarray, lam, n_cams: int):
    """[J_pt; sqrt(lam) I3] blocks and the RHS (-res at observation rows, zeros at
    the interleaved point-damping rows)."""
    n_pts = jp.shape[0]
    dt = jp.dtype
    sl = jnp.sqrt(lam).astype(dt)
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=dt), (n_pts, 3, 3))
    left_d = jnp.concatenate([jp, sl * eye3], axis=1)  # [P, 2C+3, 3]
    rhs = jnp.concatenate(
        [-res.reshape(n_pts, 2 * n_cams), jnp.zeros((n_pts, 3), dt)], axis=1
    ).reshape(-1)
    return left_d, rhs


class _BundleStep:
    """Damped-step functor: one block-angular QR solve per call.

    The camera block's sparsity pattern (which rows touch which camera
    columns) is static across iterations; only its values change, so the
    triplet index arrays are built once.
    """

    def __init__(self, uv: np.ndarray):
        self.uv = jnp.asarray(uv)
        n_pts, n_cams = uv.shape[0], uv.shape[1]
        self.n_pts, self.n_cams = n_pts, n_cams
        brows = 2 * n_cams + 3
        self.n1 = n_pts * brows + 6 * n_cams
        # observation rows of A2: row p*brows + 2c + k, cols 6c..6c+6
        p, c, k, j = np.meshgrid(
            np.arange(n_pts), np.arange(n_cams), np.arange(2), np.arange(6),
            indexing="ij",
        )
        self._a2_rows = (p * brows + 2 * c + k).reshape(-1)
        self._a2_cols = (6 * c + j).reshape(-1)
        # camera damping rows: sqrt(lam) I at the zero-tail of A1
        self._damp_rows = n_pts * brows + np.arange(6 * n_cams)
        self._damp_cols = np.arange(6 * n_cams)
        self.last_qr: Optional[BlockAngularQR] = None

    def __call__(self, x: jnp.ndarray, r: jnp.ndarray, lam: float) -> jnp.ndarray:
        jp, jc = _jacobian_blocks(x, self.uv)
        left_d, rhs = _damped_left_rhs(jp, r, lam, self.n_cams)
        blk = BlockDiagonal.from_dense_batch(
            left_d, nrows=self.n1, ncols=3 * self.n_pts
        )
        sl = float(np.sqrt(lam))
        a2 = SparseCSR.from_triplets(
            np.concatenate([self._a2_rows, self._damp_rows]),
            np.concatenate([self._a2_cols, self._damp_cols]),
            np.concatenate(
                [np.asarray(jc).reshape(-1), np.full(6 * self.n_cams, sl)]
            ),
            (self.n1, 6 * self.n_cams),
        )
        qr = BlockAngularQR(BlockDiagonalQR(), DenseColPivQR()).compute(
            BlockMatrix1x2(blk, a2)
        )
        self.last_qr = qr
        b = jnp.concatenate([rhs, jnp.zeros((6 * self.n_cams,), rhs.dtype)])
        rperm = qr.rows_permutation()
        if not rperm.is_identity():
            b = jnp.asarray(rperm.apply(np.asarray(b)))
        return qr.solve(b)


def fit_bundle(
    cams0: np.ndarray,
    pts0: np.ndarray,
    uv: np.ndarray,
    config: Optional[LMConfig] = None,
) -> LMResult:
    """LM bundle adjustment from an initial guess (cams0, pts0).

    Host LM loop over the class-based solver composition — the API-parity
    demo.  For production (one compiled program per fit, no per-iteration
    host round trips) use :func:`fit_bundle_device`.
    """
    x0 = jnp.concatenate(
        [jnp.asarray(pts0).reshape(-1), jnp.asarray(cams0).reshape(-1)]
    )
    uvd = jnp.asarray(uv)
    step = _BundleStep(np.asarray(uv))
    return levenberg_marquardt(
        lambda x: residuals(x, uvd),
        step,
        x0,
        config or LMConfig(max_iters=50),
    )


@functools.lru_cache(maxsize=8)
def _make_damped_step(n_shards: int):
    """Fully-traceable damped bundle step — the fused block-angular LS solve.

    Identical math to :class:`_BundleStep`, but the camera block assembles as
    a dense [n1 + 6C, 6C] operand ON DEVICE (6C columns: dense is the right
    layout at this width) and the whole step is jit-traceable, so
    :func:`~qrkit_tpu.lm.levenberg_marquardt_device` can compile the entire
    minimize into one ``lax.while_loop`` program.

    ``n_shards > 1`` is the point-axis distribution: with ``uv`` sharded over
    the mesh's dp axis the per-point block QR partitions with zero
    communication and the camera-block TSQR's second-stage all-gather is the
    only collective (the documented mitigation for the one-chip HBM ceiling
    at ~100-200k points).  The returned function is cached per shard count so
    the device-LM compile cache keys stay stable."""

    def step(x, r, lam, uv):
        n_pts, n_cams = uv.shape[0], uv.shape[1]
        brows = 2 * n_cams + 3
        c6 = 6 * n_cams
        jp, jc = _jacobian_blocks(x, uv)
        left_d, rhs = _damped_left_rhs(jp, r, lam, n_cams)
        dt = left_d.dtype
        # per-point camera block [2C, 6C] scattered from jc [P, C, 2, 6]
        c, k, j = np.meshgrid(
            np.arange(n_cams), np.arange(2), np.arange(6), indexing="ij"
        )
        a2p = (
            jnp.zeros((n_pts, 2 * n_cams, c6), dt)
            .at[:, (2 * c + k).ravel(), (6 * c + j).ravel()]
            .set(jc.reshape(n_pts, -1))
        )
        a2_blocks = jnp.concatenate(
            [a2p, jnp.zeros((n_pts, 3, c6), dt)], axis=1
        ).reshape(n_pts * brows, c6)
        sl = jnp.sqrt(lam).astype(dt)
        a2 = jnp.concatenate([a2_blocks, sl * jnp.eye(c6, dtype=dt)], axis=0)
        b = jnp.concatenate([rhs, jnp.zeros((c6,), dt)])
        from ..functional import block_angular_lstsq

        return block_angular_lstsq(left_d, a2, b, n_shards=n_shards, tail=c6)

    return step


_damped_step_device = _make_damped_step(1)


def _residuals_aux(x, uv):
    return residuals(x, uv)


def fit_bundle_device(
    cams0: np.ndarray,
    pts0: np.ndarray,
    uv: np.ndarray,
    config: Optional[LMConfig] = None,
    mesh=None,
    axis: str = "dp",
) -> LMResult:
    """Whole-minimize-on-device bundle adjustment: damped step, acceptance,
    λ adaptation and convergence checks compile into ONE ``lax.while_loop``
    program (the ellipse benchmark's recipe applied to the real domain) —
    per fit there is one dispatch and one result fetch, instead of ~30
    dispatches and host syncs per LM iteration.

    ``mesh`` shards the POINT axis of the scene over the mesh's ``axis``:
    observations (and with them the per-point Jacobian blocks, the damped
    block QR, and the camera-block rows feeding the TSQR) partition across
    devices, dividing the fused program's HBM footprint by the device count —
    the mitigation for the one-chip ceiling at ~100-200k points.  The only
    collective is the TSQR second-stage all-gather of [6C, 6C] R factors."""
    x0 = jnp.concatenate(
        [jnp.asarray(pts0).reshape(-1), jnp.asarray(cams0).reshape(-1)]
    )
    uvd = jnp.asarray(uv)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        uvd = jax.device_put(uvd, NamedSharding(mesh, P(axis, None, None)))
        step = _make_damped_step(int(mesh.devices.size))
    else:
        step = _damped_step_device
    return levenberg_marquardt_device(
        _residuals_aux,
        step,
        x0,
        config or LMConfig(max_iters=50),
        aux=uvd,
    )
