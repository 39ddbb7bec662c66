"""Bundle-adjustment benchmark — the reference's target domain at scale.

LM bundle adjustment (qrkit_tpu.examples.bundle: block-diagonal point blocks
+ sparse camera columns through BlockAngularQR) on synthetic scenes of
increasing size; prints one JSON line per scene.  Timing is the full
minimize wall time (the host LM loop fetches the cost each iteration, so
the number is fetch-fenced by construction).

Usage: python examples/bench_bundle.py [\"P,C\" ...]   (default 200,4 1000,8 5000,8)
"""
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from qrkit_tpu import LMConfig
from qrkit_tpu.examples.bundle import fit_bundle, fit_bundle_device, make_scene


def main():
    from qrkit_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    args = [a for a in sys.argv[1:] if a != "--host-loop"]
    host_loop = "--host-loop" in sys.argv[1:]
    cases = args or ["200,4", "1000,8", "5000,8", "20000,8"]
    fit = fit_bundle if host_loop else fit_bundle_device
    for case in cases:
        n_pts, n_cams = (int(v) for v in case.split(","))
        cams, pts, uv = make_scene(n_cams=n_cams, n_pts=n_pts, noise=1e-3, seed=3)
        rng = np.random.default_rng(7)
        cams0 = cams + 0.02 * rng.normal(size=cams.shape)
        pts0 = pts + 0.02 * rng.normal(size=pts.shape)

        t0 = time.perf_counter()
        res = fit(cams0, pts0, uv, LMConfig(max_iters=40))
        warm = time.perf_counter() - t0  # includes jit compiles
        t0 = time.perf_counter()
        res = fit(cams0, pts0, uv, LMConfig(max_iters=40))
        sec = time.perf_counter() - t0

        n_obs = 2 * n_pts * n_cams
        rms = float(np.sqrt(2.0 * res.cost / n_obs))
        print(json.dumps({
            "driver": "host_loop" if host_loop else "device_while_loop",
            "n_pts": n_pts,
            "n_cams": n_cams,
            "n_obs": n_obs,
            "params": 3 * n_pts + 6 * n_cams,
            "seconds": round(sec, 3),
            "seconds_cold": round(warm, 3),
            "iterations": res.iterations,
            "rms_reproj": rms,
        }))


if __name__ == "__main__":
    main()
