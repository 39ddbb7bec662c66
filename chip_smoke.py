"""On-card smoke run: the library's main paths at real sizes, each checked
against a plain fp64 reference.

    python chip_smoke.py              # one GPU, every phase below
    python chip_smoke.py --devices 4  # the mesh paths on four GPUs, each
                                      # compared with the same problem on one

Everything runs in this one process.  With no GPU the script exits non-zero
and prints no result line; a failing phase raises, so the exit code is
non-zero too.  The first line is the card's name and power limit; then one
line per check with its sizes, the path the library selected, the precision,
compile and run seconds (information only, not a benchmark), and the
largest error beside its tolerance.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Tolerances.  Each is the error the same fp32 program shows on the CPU
backend at a reduced size (``python chip_smoke.py --cpu-baseline`` prints
those), times a stated factor.  A float32 product that leaks into TF32
(about 1e-3 relative) overshoots every one of them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# name -> (tolerance, reason).  "CPU" is the error of the same fp32 program
# on the CPU backend at the CPU_BASELINE sizes below; a TF32 product keeps
# ~3 decimal digits and reads 1e-4..1e-3 on every one of these measures.
TOL = {
    # consistent 7x2 systems: relative residual ||Ax-b||/||b||, the gate
    # bench.py has always used (CPU 1.1e-7)
    "blockdiag_resid": (1e-4, "bench.py gate; CPU 1.1e-7"),
    # max |dx| / max |x| against NumPy fp64 (CPU 7.9e-7 at 10k blocks); x40
    # because the worst-conditioned of 1M random blocks is worse than of 10k
    "blockdiag_x": (3e-5, "CPU 7.9e-7 x40 (worst of 1M vs 10k blocks)"),
    # max |dx| / max |x| against scipy fp64 (CPU 9.8e-7 at 300 blocks); x30
    # for the 8x longer chain and its boundary back-substitution
    "banded_x": (3e-5, "CPU 9.8e-7 x30 (2,499 vs 300 blocks)"),
    # max |dx| / max |x| against scipy fp64 (CPU 1.8e-5 at N=20k); x10: the
    # 5-column reduction sums 25x more rows (~5x in rounding)
    "block_angular_x": (2e-4, "CPU 1.8e-5 x10 (N=500k vs 20k)"),
    # max |d(a, b, x0, y0, r)| against the generating ellipse (noise-free
    # points).  CPU read 1.1e-8, but the fp32 spacing at |y0| = 23 is
    # 1.9e-6, so the bound is ~50 ulps of the largest parameter
    "ellipse_params": (1e-4, "CPU 1.1e-8; 50 fp32 ulps at |y0|=23"),
    # final cost 0.5||r||^2 per point at the noise-free optimum (CPU
    # 1.4e-13); fp32 rounding of a residual near 23 alone gives ~4e-12
    "ellipse_cost_per_point": (1e-10, "CPU 1.4e-13; 25x the fp32 floor 4e-12"),
    # worst parameter error over the batch (CPU 1.1e-6 over 100 fits)
    "ellipse_batch_params": (1e-4, "CPU 1.1e-6 over 100 fits; 50 ulps at 23"),
    # first damped step against a scipy fp64 solve of the same damped
    # system, ||d - d_ref|| / ||d_ref||.  The damped system's conditioning
    # grows with the point count: CPU 2.4e-6 at 5,000 points, 1.25e-4 at the
    # full 100k (read there, not extrapolated); x6.  TF32 would read ~1.
    "bundle_step": (7.5e-4, "CPU 1.25e-4 at 100k points x6"),
    # final over initial cost after 10 LM iterations on noise-free data
    # (CPU 7.1e-12 at 100k points): the fit must reach the optimum; scene
    # data or residuals computed in TF32 leave a floor near 1e-5
    "bundle_cost_ratio": (1e-8, "CPU 7.1e-12 at 100k x1000; must reach the optimum"),
    # four-card vs one-card results: the reduction order differs, and the
    # TSQR tree differs from one Householder QR (4 virtual CPU devices: 5e-6
    # at N=4k for TSQR, <=1.7e-6 elsewhere); x20 for N=500k
    "mesh_vs_single": (1e-4, "4 virtual CPU devices 5e-6 x20 (500k vs 4k rows)"),
}

FULL = dict(
    blockdiag=dict(nb=1_000_000),
    banded=dict(nb=2499),
    block_angular=dict(n=500_000),
    ellipse=dict(n=500_000, batch=1000, batch_n=500),
    bundle=dict(n_pts=100_000, n_cams=8, iters=10),
)
# the reduced sizes the tolerances above were read at on the CPU backend
CPU_BASELINE = dict(
    blockdiag=dict(nb=10_000),
    banded=dict(nb=300),
    block_angular=dict(n=20_000),
    ellipse=dict(n=20_000, batch=100, batch_n=500),
    bundle=dict(n_pts=100_000, n_cams=8, iters=10),
)
MESH_FULL = dict(nb=1_000_000, chain=20_000, n=500_000, bundle_pts=500_000)


def _timed(fn):
    """(result, first-call seconds, second-call seconds): the first call
    compiles, the second reuses the compiled programs."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t2 = time.perf_counter()
    return out, t1 - t0, t2 - t1


def _line(phase, check, sizes, path, err, tol_key, t_first, t_run, dtype="float32"):
    tol = TOL[tol_key][0]
    rec = dict(
        phase=phase, check=check, sizes=sizes, path=path,
        precision=f"{dtype}, matmul highest", compile_s=max(t_first - t_run, 0.0),
        run_s=t_run, err=float(err), tol=tol,
    )
    print(json.dumps(rec), flush=True)
    if not (np.isfinite(err) and err <= tol):
        raise AssertionError(f"{phase}/{check}: error {err} above tolerance {tol}")
    return rec


def _rel_inf(x, ref):
    x = np.asarray(x, np.float64)
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


# --- block-diagonal -----------------------------------------------------------


def block_system(nb, br=7, bc=2, seed=0):
    rng = np.random.default_rng(seed)
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    x = rng.normal(size=(nb, bc))
    b = np.einsum("bij,bj->bi", blocks, x).reshape(-1)
    return blocks, b


def block_lstsq_ref(blocks, b):
    """NumPy fp64 batched QR solve of every block."""
    nb, br, bc = blocks.shape
    q, r = np.linalg.qr(blocks)
    y = np.einsum("bij,bi->bj", q, b.reshape(nb, br))
    return np.linalg.solve(r, y[..., None])[..., 0].reshape(-1)


def phase_blockdiag(nb):
    import jax.numpy as jnp

    from qrkit_tpu import BlockDiagonal, BlockDiagonalQR, QFormat
    from qrkit_tpu.functional import block_diagonal_lstsq

    blocks, b = block_system(nb)
    ref = block_lstsq_ref(blocks, b)
    a_d = jnp.asarray(blocks, jnp.float32)
    b_d = jnp.asarray(b, jnp.float32)
    mat = BlockDiagonal(a_d, nb * 7, nb * 2)
    sizes = dict(blocks=nb, block=[7, 2])
    out = []
    for check, pivot in (("householder", False), ("colpiv", True)):
        qr = BlockDiagonalQR(QFormat.FULL_Q, pivot=pivot)
        x, t1, t2 = _timed(lambda: qr.compute(mat).solve(b_d))
        path = "triton" if qr._pallas_mode else "xla"
        xh = np.asarray(x, np.float64)
        resid = np.linalg.norm(
            np.einsum("bij,bj->bi", blocks, xh.reshape(nb, 2)).reshape(-1) - b
        ) / np.linalg.norm(b)
        out.append(_line("blockdiag", f"{check}_resid", sizes, path, resid, "blockdiag_resid", t1, t2))
        out.append(_line("blockdiag", f"{check}_x", sizes, path, _rel_inf(xh, ref), "blockdiag_x", t1, t2))
    x, t1, t2 = _timed(lambda: block_diagonal_lstsq(a_d, b_d))
    out.append(_line("blockdiag", "functional_x", sizes, "xla", _rel_inf(x, ref), "blockdiag_x", t1, t2))
    return out


# --- banded -------------------------------------------------------------------


def banded_matrix(nb, br=40, bc=8, ov=4, seed=0, scale=None):
    """BASELINE config 3: nb blocks of br x bc overlapping ov columns."""
    from qrkit_tpu.sparse import SparseCSR

    rng = np.random.default_rng(seed)
    step = bc - ov
    ncols = step * nb + ov
    i = np.arange(nb)[:, None, None]
    r = np.arange(br)[None, :, None]
    c = np.arange(bc)[None, None, :]
    rows = np.broadcast_to(i * br + r, (nb, br, bc)).ravel()
    cols = np.broadcast_to(i * step + c, (nb, br, bc)).ravel()
    keep = cols < ncols
    vals = rng.uniform(0.5, 5.0, size=rows.size)
    return SparseCSR.from_triplets(rows[keep], cols[keep], vals[keep], (br * nb, ncols))


def sparse_lstsq_ref(a, b):
    """scipy.sparse fp64 least squares through the normal equations."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    a = sp.csr_matrix(a)
    return spla.spsolve((a.T @ a).tocsc(), a.T @ b)


def _scipy(mat):
    import scipy.sparse as sp

    return sp.csr_matrix((mat.data, mat.indices, mat.indptr), shape=mat.shape)


def phase_banded(nb):
    import jax
    import jax.numpy as jnp

    from qrkit_tpu import BandedBlockedQR, SparseCSR, auto_qr

    # the banded solvers factorize host data in the process's float width
    dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    mat = banded_matrix(nb)
    rng = np.random.default_rng(1)
    a = _scipy(mat)
    b = a @ rng.normal(size=mat.ncols)
    ref = sparse_lstsq_ref(a, b)
    sizes = dict(blocks=nb, block=[40, 8], overlap=4, shape=list(mat.shape))
    out = []

    t0 = time.perf_counter()
    qr = auto_qr(mat, suggested_block_cols=8)
    t_compute = time.perf_counter() - t0
    if qr.selection != "segmented_banded":
        raise AssertionError(f"auto_qr selected {qr.selection}, not segmented_banded")
    bp = jnp.asarray(qr.rows_permutation().apply(b), dt)
    x, t1, t2 = _timed(lambda: qr.solve(bp))
    out.append(_line("banded", "auto_qr_solve", sizes, f"xla ({qr.selection})",
                     _rel_inf(x, ref), "banded_x", t_compute + t1, t2, str(x.dtype)))

    # device-resident refactorize with fresh values, then solve
    data2 = mat.data * rng.uniform(0.9, 1.1, size=mat.data.size)
    mat2 = SparseCSR(mat.shape, mat.indptr, mat.indices, data2)
    a2 = _scipy(mat2)
    b2 = a2 @ rng.normal(size=mat.ncols)
    ref2 = sparse_lstsq_ref(a2, b2)
    v2 = jnp.asarray(data2, dt)
    bp2 = jnp.asarray(qr.rows_permutation().apply(b2), dt)
    x2, t1, t2 = _timed(lambda: qr.factorize_values(v2).solve(bp2))
    out.append(_line("banded", "factorize_values_solve", sizes, f"xla ({qr.selection})",
                     _rel_inf(x2, ref2), "banded_x", t1, t2, str(x2.dtype)))

    plain = BandedBlockedQR(suggested_block_cols=8)
    t0 = time.perf_counter()
    plain.compute(mat)
    t_compute = time.perf_counter() - t0
    bpp = jnp.asarray(plain.rows_permutation().apply(b), dt)
    x3, t1, t2 = _timed(lambda: plain.solve(bpp))
    out.append(_line("banded", "plain_chain_solve", sizes, "xla (banded_blocked)",
                     _rel_inf(x3, ref), "banded_x", t_compute + t1, t2, str(x3.dtype)))
    return out


# --- block-angular --------------------------------------------------------------


def angular_problem(n, m2=5, seed=0):
    """Ellipse-Jacobian shape [J1 | J2]: J1 2N x N of 2x1 blocks, J2 2N x 5."""
    rng = np.random.default_rng(seed)
    blocks = rng.uniform(0.5, 5.0, size=(n, 2, 1))
    a2 = rng.uniform(0.5, 5.0, size=(2 * n, m2))
    xt = rng.normal(size=n + m2)
    b = (blocks[:, :, 0] * xt[:n, None]).reshape(-1) + a2 @ xt[n:]
    return blocks, a2, b


def angular_ref(blocks, a2, b):
    import scipy.sparse as sp

    n = blocks.shape[0]
    j1 = sp.csr_matrix(
        (blocks.reshape(-1), np.repeat(np.arange(n), 2), np.arange(2 * n + 1)),
        shape=(2 * n, n),
    )
    return sparse_lstsq_ref(sp.hstack([j1, sp.csr_matrix(a2)]), b)


def phase_block_angular(n):
    import jax.numpy as jnp

    from qrkit_tpu import (
        BlockAngularQR, BlockDiagonal, BlockDiagonalQR, BlockMatrix1x2,
        DenseColPivQR, QFormat,
    )

    blocks, a2, b = angular_problem(n)
    ref = angular_ref(blocks, a2, b)
    sizes = dict(N=n, shape=[2 * n, n + 5])
    blk = jnp.asarray(blocks, jnp.float32)
    a2_d = jnp.asarray(a2, jnp.float32)
    b_d = jnp.asarray(b, jnp.float32)
    soa = jnp.asarray(np.ascontiguousarray(blocks.transpose(1, 2, 0).reshape(2, n)), jnp.float32)
    a2t = jnp.asarray(np.ascontiguousarray(a2.T), jnp.float32)

    def solver():
        return BlockAngularQR(BlockDiagonalQR(QFormat.FULL_Q, pivot=False), DenseColPivQR())

    layouts = {
        "aos": lambda: BlockMatrix1x2(BlockDiagonal(blk, 2 * n, n), a2_d),
        "lane_major": lambda: BlockMatrix1x2(
            BlockDiagonal.from_soa(soa, 2, 1, nrows=2 * n), a2t, right_t=True
        ),
    }
    out = []
    for name, mk in layouts.items():
        qr = solver()
        x, t1, t2 = _timed(lambda: qr.compute(mk()).solve(b_d))
        path = "xla (fused_soa)" if qr._fused_soa else "xla (fused_dense)"
        out.append(_line("block_angular", f"{name}_compute_solve", sizes, path,
                         _rel_inf(x, ref), "block_angular_x", t1, t2))
        qr2 = solver()
        x, t1, t2 = _timed(lambda: qr2.compute_solve(mk(), b_d))
        out.append(_line("block_angular", f"{name}_compute_solve_fused", sizes, path,
                         _rel_inf(x, ref), "block_angular_x", t1, t2))
    return out


# --- ellipse LM ---------------------------------------------------------------


def phase_ellipse(n, batch, batch_n):
    import jax.numpy as jnp

    from qrkit_tpu.examples.ellipse import (
        Ellipse, canonicalize_ellipse, ellipse_points, fit_ellipse, fit_ellipse_batch,
    )
    from qrkit_tpu.lm import LMConfig

    el = Ellipse(7.5, 2.0, 17.0, 23.0, 0.23)
    truth = np.array([el.a, el.b, el.x0, el.y0, el.r])
    pts = ellipse_points(el, n)
    cfg = LMConfig(max_iters=40, ftol=1e-8, xtol=1e-8)
    (res, params), t1, t2 = _timed(lambda: fit_ellipse(pts, cfg, dtype=jnp.float32))
    dtype = str(np.asarray(res.x).dtype)
    sizes = dict(N=n, iterations=res.iterations)
    out = [
        _line("ellipse_lm", "fit_params", sizes, "xla (device loop)",
              np.max(np.abs(params[n:] - truth)), "ellipse_params", t1, t2, dtype),
        _line("ellipse_lm", "fit_cost_per_point", sizes, "xla (device loop)",
              res.cost / n, "ellipse_cost_per_point", t1, t2, dtype),
    ]

    rng = np.random.default_rng(0)
    els = [
        Ellipse(7.5 + 0.5 * rng.normal(), 2.0 + 0.2 * rng.normal(),
                17.0 + rng.normal(), 23.0 + rng.normal(), 0.23 + 0.05 * rng.normal())
        for _ in range(batch)
    ]
    pts_b = np.stack([ellipse_points(e, batch_n) for e in els])
    cfg_b = LMConfig(max_iters=60)
    rb, t1, t2 = _timed(lambda: fit_ellipse_batch(pts_b, cfg_b, dtype=jnp.float32))
    xb = np.asarray(rb.x, np.float64)
    err = 0.0
    for k, e in enumerate(els):
        p = canonicalize_ellipse(xb[k], batch_n)[batch_n:]
        t = canonicalize_ellipse(
            np.concatenate([np.zeros(batch_n), [e.a, e.b, e.x0, e.y0, e.r]]), batch_n
        )[batch_n:]
        err = max(err, float(np.max(np.abs(p - t))))
    out.append(_line("ellipse_lm", "batch_fit_params", dict(batch=batch, N=batch_n),
                     "xla (vmapped device loop)", err, "ellipse_batch_params", t1, t2,
                     str(np.asarray(rb.x).dtype)))
    return out


# --- bundle LM ----------------------------------------------------------------


def bundle_problem(n_pts, n_cams, seed=0):
    from qrkit_tpu.examples.bundle import make_scene

    cams, pts, uv = make_scene(n_cams=n_cams, n_pts=n_pts, seed=seed)
    rng = np.random.default_rng(seed + 1)
    cams0 = cams + 0.01 * rng.normal(size=cams.shape)
    pts0 = pts + 0.02 * rng.normal(size=pts.shape)
    return cams0, pts0, uv


def bundle_step_ref(x, uv, lam):
    """scipy fp64 solve of the damped system [J; sqrt(lam) I] d = [-r; 0],
    with J the sparse point/camera Jacobian at x (computed in fp64 on the
    host's NumPy copy of the device Jacobian blocks)."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from qrkit_tpu.examples.bundle import _jacobian_blocks, residuals

    n_pts, n_cams = uv.shape[0], uv.shape[1]
    with jax.default_matmul_precision("highest"):
        xd, uvd = jnp.asarray(x, jnp.float32), jnp.asarray(uv, jnp.float32)
        jp, jc = _jacobian_blocks(xd, uvd)
        r = np.asarray(residuals(xd, uvd), np.float64)
    jp = np.asarray(jp, np.float64)  # [P, 2C, 3]
    jc = np.asarray(jc, np.float64)  # [P, C, 2, 6]
    m = 2 * n_cams * n_pts
    rows_p = np.repeat(np.arange(m), 3)
    cols_p = (np.arange(n_pts)[:, None, None] * 3 + np.arange(3)[None, None, :]).repeat(2 * n_cams, 1).reshape(-1)
    p, c, k, j = np.meshgrid(np.arange(n_pts), np.arange(n_cams), np.arange(2), np.arange(6), indexing="ij")
    rows_c = (p * 2 * n_cams + 2 * c + k).reshape(-1)
    cols_c = (3 * n_pts + 6 * c + j).reshape(-1)
    n = 3 * n_pts + 6 * n_cams
    jm = sp.csr_matrix(
        (np.concatenate([jp.reshape(-1), jc.reshape(-1)]),
         (np.concatenate([rows_p, rows_c]), np.concatenate([cols_p, cols_c]))),
        shape=(m, n),
    )
    lhs = (jm.T @ jm + lam * sp.identity(n)).tocsc()
    return spla.spsolve(lhs, -(jm.T @ r)), r


def phase_bundle(n_pts, n_cams, iters):
    import jax
    import jax.numpy as jnp

    from qrkit_tpu.examples.bundle import _damped_step_device, fit_bundle_device
    from qrkit_tpu.lm import LMConfig

    cams0, pts0, uv = bundle_problem(n_pts, n_cams)
    x0 = np.concatenate([pts0.reshape(-1), cams0.reshape(-1)])
    lam = LMConfig().lambda_init
    ref, r0 = bundle_step_ref(x0, uv, lam)
    xd = jnp.asarray(x0, jnp.float32)
    uvd = jnp.asarray(uv, jnp.float32)
    step = jax.jit(_damped_step_device)
    rd = jnp.asarray(r0, jnp.float32)
    d, t1, t2 = _timed(lambda: step(xd, rd, jnp.float32(lam), uvd))
    sizes = dict(points=n_pts, cameras=n_cams, observations=n_pts * n_cams)
    d = np.asarray(d, np.float64)
    out = [_line("bundle_lm", "first_damped_step", sizes, "xla (fused block-angular)",
                 np.linalg.norm(d - ref) / np.linalg.norm(ref), "bundle_step", t1, t2)]

    cfg = LMConfig(max_iters=iters)
    res, t1, t2 = _timed(lambda: fit_bundle_device(
        cams0.astype(np.float32), pts0.astype(np.float32), uv.astype(np.float32), cfg
    ))
    cost0 = 0.5 * float(r0 @ r0)
    sizes = dict(sizes, iterations=res.iterations)
    out.append(_line("bundle_lm", "cost_ratio", sizes, "xla (device loop)",
                     res.cost / cost0, "bundle_cost_ratio", t1, t2,
                     str(np.asarray(res.x).dtype)))
    return out


# --- four cards -----------------------------------------------------------------


def _spread(x, n):
    """Assert that ``x`` (or every leaf) lives on ``n`` devices."""
    import jax

    for leaf in jax.tree_util.tree_leaves(x):
        got = len(leaf.sharding.device_set)
        if got != n:
            raise AssertionError(f"array {leaf.shape} lives on {got} devices, not {n}")


def _mesh_line(check, sizes, err, t1, t2, n):
    return _line("mesh", check, dict(sizes, devices=n), f"xla (mesh of {n})",
                 err, "mesh_vs_single", t1, t2)


def phase_mesh(nb, chain, n, bundle_pts, ndev=4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qrkit_tpu import BlockDiagonal, BlockDiagonalQR, QFormat, SegmentedBandedQR
    from qrkit_tpu.examples.bundle import (
        _damped_step_device, _make_damped_step, fit_bundle_device, residuals,
    )
    from qrkit_tpu.functional import block_angular_lstsq
    from qrkit_tpu.lm import LMConfig
    from qrkit_tpu.parallel.mesh import default_mesh, shard_leading_axis
    from qrkit_tpu.parallel.tsqr import TSQRDenseQR
    from qrkit_tpu.solvers import DenseHouseholderQR

    if len(jax.devices()) < ndev:
        raise SystemExit(f"--devices {ndev} needs {ndev} GPUs, found {len(jax.devices())}")
    mesh = default_mesh(ndev)
    out = []

    # block-diagonal, leading (block) axis sharded
    blocks, b = block_system(nb)
    a_d = jnp.asarray(blocks, jnp.float32)
    b_d = jnp.asarray(b, jnp.float32)
    mat = BlockDiagonal(a_d, nb * 7, nb * 2)
    single = BlockDiagonalQR(QFormat.FULL_Q, pivot=False, use_pallas=False)
    x1 = np.asarray(single.compute(mat).solve(b_d), np.float64)
    sharded = BlockDiagonalQR(QFormat.FULL_Q, pivot=False, mesh=mesh)
    x4, t1, t2 = _timed(lambda: sharded.compute(mat).solve(b_d))
    _spread((sharded.Q, sharded.R), ndev)
    out.append(_mesh_line("blockdiag", dict(blocks=nb), _rel_inf(x4, x1), t1, t2, ndev))

    # segmented banded chain, segment axis sharded (L chosen so S % ndev == 0)
    cmat = banded_matrix(chain, br=21, bc=10, ov=4)
    L = next(l for l in range(32, 8, -1) if -(-chain // l) % ndev == 0)
    cb = _scipy(cmat) @ np.random.default_rng(2).normal(size=cmat.ncols)
    q1 = SegmentedBandedQR(suggested_block_cols=10, segment_blocks=L).compute(cmat)
    y1 = np.asarray(q1.solve(jnp.asarray(q1.rows_permutation().apply(cb), jnp.float32)), np.float64)
    q4 = SegmentedBandedQR(suggested_block_cols=10, segment_blocks=L, mesh=mesh)
    bp = jnp.asarray(q1.rows_permutation().apply(cb), jnp.float32)
    y4, t1, t2 = _timed(lambda: q4.compute(cmat).solve(bp))
    _spread((q4._Yws, q4._Ts, q4._r_panels, q4._Yb), ndev)
    out.append(_mesh_line("segmented_banded", dict(blocks=chain, block=[21, 10], L=L, S=q4.S),
                          _rel_inf(y4, y1), t1, t2, ndev))

    # block-angular with the TSQR right block over ndev shards
    blk, a2, bb = angular_problem(n)
    blk_d = jnp.asarray(blk, jnp.float32)
    a2_d = jnp.asarray(a2, jnp.float32)
    bb_d = jnp.asarray(bb, jnp.float32)
    xa1 = np.asarray(block_angular_lstsq(blk_d, a2_d, bb_d, n_shards=1), np.float64)
    blk_s, a2_s, bb_s = shard_leading_axis((blk_d, a2_d, bb_d), mesh)
    xa4, t1, t2 = _timed(lambda: block_angular_lstsq(blk_s, a2_s, bb_s, n_shards=ndev))
    _spread((blk_s, a2_s), ndev)
    out.append(_mesh_line("block_angular_lstsq", dict(N=n), _rel_inf(xa4, xa1), t1, t2, ndev))

    dense1 = DenseHouseholderQR().compute(a2_d)
    xt1 = np.asarray(dense1.solve(bb_d), np.float64)
    tq = TSQRDenseQR(ndev, mesh)
    xt4, t1, t2 = _timed(lambda: tq.compute(a2_s).solve(bb_s))
    out.append(_mesh_line("tsqr_dense", dict(rows=2 * n, cols=5), _rel_inf(xt4, xt1), t1, t2, ndev))

    # point-sharded bundle: the damped step against the same step on one
    # card, then the sharded fit and the same fit on one card
    cams0, pts0, uv = bundle_problem(bundle_pts, 8)
    x0 = jnp.asarray(np.concatenate([pts0.reshape(-1), cams0.reshape(-1)]), jnp.float32)
    uv1 = jnp.asarray(uv, jnp.float32)
    uv4 = jax.device_put(uv1, NamedSharding(mesh, P("dp", None, None)))
    r0 = residuals(x0, uv1)
    lam = jnp.float32(LMConfig().lambda_init)
    d1 = np.asarray(jax.jit(_damped_step_device)(x0, r0, lam, uv1), np.float64)
    step4 = jax.jit(_make_damped_step(ndev))
    d4, t1, t2 = _timed(lambda: step4(x0, r0, lam, uv4))
    _spread(uv4, ndev)
    bsizes = dict(points=bundle_pts, cameras=8)
    out.append(_mesh_line("bundle_damped_step", bsizes,
                          np.linalg.norm(np.asarray(d4, np.float64) - d1) / np.linalg.norm(d1),
                          t1, t2, ndev))
    cfg = LMConfig(max_iters=10)
    args = (cams0.astype(np.float32), pts0.astype(np.float32), uv.astype(np.float32), cfg)
    cost0 = 0.5 * float(np.sum(np.asarray(r0, np.float64) ** 2))
    for name, kw in (("bundle_lm_one_card", {}), ("bundle_lm_mesh", dict(mesh=mesh))):
        res, t1, t2 = _timed(lambda: fit_bundle_device(*args, **kw))
        path = f"xla (mesh of {ndev})" if kw else "xla (one card)"
        out.append(_line("mesh", f"{name}_cost_ratio", dict(bsizes, iterations=res.iterations),
                         path, res.cost / cost0, "bundle_cost_ratio", t1, t2))
    return out


# --- driver -----------------------------------------------------------------------


def run_phases(sizes):
    out = []
    out += phase_blockdiag(**sizes["blockdiag"])
    out += phase_banded(**sizes["banded"])
    out += phase_block_angular(**sizes["block_angular"])
    out += phase_ellipse(**sizes["ellipse"])
    out += phase_bundle(**sizes["bundle"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    ap.add_argument("--cpu-baseline", action="store_true",
                    help="run every phase on the CPU backend at the reduced "
                         "sizes the tolerances were read at")
    args = ap.parse_args(argv)

    from qrkit_tpu.runtime import card_info, enable_compile_cache, require_gpu

    if args.cpu_baseline:
        import jax

        jax.config.update("jax_platforms", "cpu")
        run_phases(CPU_BASELINE)
        return 0

    enable_compile_cache()
    import jax

    require_gpu()
    print(card_info(), flush=True)
    if args.devices == 4:
        phase_mesh(**MESH_FULL)
    else:
        run_phases(FULL)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
