"""Benchmark driver — prints ONE JSON line.

Times the flagship pipeline (BASELINE.json config 2): block-diagonal
factorize + least-squares solve of 7×2 blocks, fp32, through the public
``BlockDiagonalQR`` API on the first GPU.  The timed step is one
``compute`` plus one vector ``solve``, ended by ``block_until_ready``; the
number is the median over ``REPS`` steps after a warm-up that compiles every
program.  ``path`` names what the library selected (``triton``: the fused
kernel of ``ops/pallas_blockdiag.py``; ``xla``: the vmapped compact-WY path),
and the result names the device it ran on.  With no GPU the script exits
non-zero; it never falls back to the CPU.

``vs_baseline`` is the speedup over the REFERENCE QRKit's own
BlockDiagonalSparseQR (ColPivHouseholderQR per block) on the same problem,
measured on the CPU of an earlier host with native/qrkit_reference_baseline.cpp
(double precision; see bench_baseline.json) — a cross-machine ratio until
the reference is measured in the same run.  ``vs_eigen_sparseqr`` keeps the
generic Eigen SparseQR(COLAMD) comparison (native/eigen_baseline.cpp) from the
same record.  A fp32 relative-residual gate guards correctness; fp64 parity
to 1e-6 is covered by tests/ on the CPU backend.

``bytes_moved`` is what one fused factorize+solve must move through device
memory (A + b + x); ``hbm_frac`` divides it by the step time and the card's
peak bandwidth from ``PEAK_HBM_BYTES_PER_S``.

Usage: python bench.py [NBLOCKS]   (default 10000)
"""
import json
import os
import statistics
import sys
import time

import numpy as np

BR, BC = 7, 2
REPS = 50

# Peak device-memory bandwidth by ``device_kind``.  Source: NVIDIA H100
# Tensor Core GPU data sheet (SXM5 part: 80 GB HBM3 at 3.35 TB/s).  A device
# that is not listed is an error, never a default.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_hbm_bytes_per_s(device_kind: str) -> float:
    try:
        return PEAK_HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak bandwidth on record for device kind {device_kind!r}"
        ) from None


def _baselines(nb: int):
    """(reference QRKit seconds, generic Eigen SparseQR seconds) at nb blocks."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_baseline.json")
    with open(path) as f:
        base = json.load(f)

    def lookup(table, power):
        if str(nb) in table:
            return float(table[str(nb)])
        # conservative extrapolation from the largest measured point (the
        # reference scales ~linearly in nb; Eigen SparseQR super-quadratically,
        # so quadratic extrapolation underestimates it → speedup lower bound)
        pts = sorted((int(k), v) for k, v in table.items())
        n0, t0 = pts[-1]
        return t0 * (nb / n0) ** power

    ref_s = lookup(base["reference_qrkit_measured"]["measured"], 1)
    eigen_s = lookup(base["measured"], 2)
    return ref_s, eigen_s


def _flops(nb: int, br: int, bc: int, iters: int = 1) -> float:
    """Closed-form flop count per factorize+solve:
    Householder QR of one br x bc panel = 2*br*bc^2 - (2/3)*bc^3, plus the
    implicit Qᵀb (3 small GEMVs ≈ 4*br*bc + 2*bc^2) and the bc x bc
    triangular solve (bc^2)."""
    qr = 2.0 * br * bc * bc - (2.0 / 3.0) * bc**3
    solve = 4.0 * br * bc + 3.0 * bc * bc
    return nb * (qr + solve) * iters


def time_step(step, reps: int = REPS) -> float:
    """Median seconds of ``step()`` (which must block on its result)."""
    step()  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main():
    nb = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    from qrkit_tpu.runtime import card_info, enable_compile_cache, require_gpu

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from qrkit_tpu import BlockDiagonal, BlockDiagonalQR, QFormat

    require_gpu()
    dev = jax.devices()[0]
    peak_bw = peak_hbm_bytes_per_s(dev.device_kind)

    rng = np.random.default_rng(0)
    blocks_np = rng.uniform(0.5, 5.0, size=(nb, BR, BC))
    x_true = rng.normal(size=nb * BC)
    b_np = np.einsum("bij,bj->bi", blocks_np, x_true.reshape(nb, BC)).reshape(-1)
    mat = BlockDiagonal(jnp.asarray(blocks_np, jnp.float32), nb * BR, nb * BC)
    b = jnp.asarray(b_np, jnp.float32)
    qr = BlockDiagonalQR(QFormat.FULL_Q, pivot=False)

    def step():
        return jax.block_until_ready(qr.compute(mat).solve(b))

    x = np.asarray(step(), np.float64)
    resid = np.einsum("bij,bj->bi", blocks_np, x.reshape(nb, BC)).reshape(-1) - b_np
    rel_resid = np.linalg.norm(resid) / np.linalg.norm(b_np)
    if not rel_resid < 1e-4:
        raise SystemExit(f"fp32 residual gate failed: {rel_resid}")
    per_step_s = time_step(step)

    bytes_moved = (BR * BC + BR + BC) * nb * 4
    ref_s, eigen_s = _baselines(nb)
    print(json.dumps({
        "metric": f"blockdiag_{nb}x{BR}x{BC}_factorize_solve_walltime",
        "value": per_step_s * 1e3,
        "unit": "ms",
        "vs_baseline": ref_s / per_step_s,
        "baseline": "reference_qrkit_blockdiagonal_cpu_record",
        "vs_eigen_sparseqr": eigen_s / per_step_s,
        "gflops": _flops(nb, BR, BC) / per_step_s / 1e9,
        "bytes_moved": bytes_moved,
        "hbm_frac": bytes_moved / per_step_s / peak_bw,
        "path": "triton" if qr._pallas_mode else "xla",
        "rel_resid": float(rel_resid),
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": card_info(),
        },
    }))


if __name__ == "__main__":
    main()
