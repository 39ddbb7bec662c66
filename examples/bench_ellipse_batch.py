"""Batched ellipse-fit throughput: B independent N-point LM fits in ONE
compiled dispatch (vmapped whole-minimize while_loop).

The reference's published small-N numbers (0.005 s at N=500) are per-problem
serial costs; at small N the accelerator's answer is throughput — amortize
the fixed per-dispatch and per-iteration launch overhead over a problem
batch.  Prints one JSON line with
total wall time and amortized per-fit time for B fits.

Usage: python examples/bench_ellipse_batch.py [B] [N]
"""
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from qrkit_tpu.examples.ellipse import Ellipse, ellipse_points, fit_ellipse_batch
from qrkit_tpu.lm import LMConfig

import jax
import jax.numpy as jnp


def main():
    from qrkit_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 500
    rng = np.random.default_rng(0)
    pts_batch = np.stack(
        [
            ellipse_points(
                Ellipse(
                    a=7.5 + 0.5 * rng.normal(),
                    b=2.0 + 0.2 * rng.normal(),
                    x0=17.0 + rng.normal(),
                    y0=23.0 + rng.normal(),
                    r=0.23 + 0.05 * rng.normal(),
                ),
                N,
            )
            for _ in range(B)
        ]
    )
    cfg = LMConfig(max_iters=60)
    dt = jnp.float32

    # warm (compile)
    res = fit_ellipse_batch(pts_batch, cfg, dtype=dt)
    t0 = time.perf_counter()
    res = fit_ellipse_batch(pts_batch, cfg, dtype=dt)  # fetches results itself
    wall = time.perf_counter() - t0
    ok = int(np.sum(np.asarray(res.cost) < 1e-4))
    print(
        json.dumps(
            {
                "metric": f"ellipse_lm_batch_{B}x{N}",
                "total_s": round(wall, 4),
                "per_fit_ms": round(wall / B * 1e3, 3),
                "fits_per_s": round(B / wall, 1),
                "converged": ok,
                "batch": B,
                "n_points": N,
                "device": jax.devices()[0].device_kind,
            }
        )
    )


if __name__ == "__main__":
    main()
