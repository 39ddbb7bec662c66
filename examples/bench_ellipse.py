#!/usr/bin/env python
"""Reproduce the reference's published ellipse-fitting benchmark table
(/root/reference/bench/bench_sparse_qr_extra.cpp:244-354, imgs/benchmark_table.png):
total Levenberg-Marquardt fit wall time vs. the number of sample points N.

Published (2018-era desktop CPU) baselines for context:
  N:        Eigen SparseQR   SuiteSparse SPQR   QRkit BlockDiag   QRkit Banded
  500       0.163 s          0.016 s            0.005 s           0.037 s
  2,000     9.798 s          0.031 s            0.017 s           0.029 s
  10,000    —                0.151 s            0.098 s           0.154 s
  100,000   —                1.816 s            1.036 s           1.718 s
  500,000   —                9.472 s            5.342 s           8.872 s

Usage: python examples/bench_ellipse.py [N ...]
Prints one JSON line per size: {"n": ..., "seconds": ..., "iterations": ...,
"cost": ...} — wall time covers the full minimize() including the first
iteration's jit compilation amortized out by a warmup fit at a tiny size.
"""
import json
import sys
import time

sys.path.insert(0, ".")

import jax.numpy as jnp
import numpy as np

from qrkit_tpu.examples.ellipse import Ellipse, ellipse_points, fit_ellipse
from qrkit_tpu.lm import LMConfig


def main():
    from qrkit_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    sizes = [int(a) for a in sys.argv[1:]] or [500, 2000, 10000, 100000, 500000]
    el = Ellipse(7.5, 2.0, 17.0, 23.0, 0.23)
    dtype = jnp.float32

    for n in sizes:
        pts = ellipse_points(el, n)
        cfg = LMConfig(max_iters=40, ftol=1e-8, xtol=1e-8)
        # warm the jit cache for this size (the reference's CPU build has no
        # compile step; we report steady-state fit time)
        fit_ellipse(pts, cfg, dtype=dtype)
        t0 = time.time()
        result, params = fit_ellipse(pts, cfg, dtype=dtype)
        dt = time.time() - t0
        print(
            json.dumps(
                {
                    "n": n,
                    "seconds": round(dt, 4),
                    "iterations": result.iterations,
                    "cost": float(result.cost),
                    "a": round(float(params[n]), 4),
                    "b": round(float(params[n + 1]), 4),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
