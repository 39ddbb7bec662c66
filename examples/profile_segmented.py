"""Stage-level device-time budget of the segmented banded solver.

Runs the fused refactorize (``factorize_values``) and solve programs of
``SegmentedBandedQR`` under ``jax.profiler`` and attributes every device
kernel to the ``jax.named_scope`` stage it was traced under
(``qrkit_tpu.profiling.stage_device_times``): extract, phase 1, phase-2
apply, CAQR and boundary chain in the refactorize; interior Qᵀ, boundary Qᵀ,
boundary back-substitution, interior rhs and interior back-substitution in
the solve.  Beside each stage it prints the bytes the stage must at least
move (its stored inputs or outputs, from array shapes) and the time that
takes at the card's peak bandwidth.  Host-clock medians of the whole
programs come from separate, untraced runs.  XLA's command buffers are off
in this process, so that every kernel is its own trace event.

Usage: python examples/profile_segmented.py [config3|NBLOCKS] [--reps R] [--out DIR]
(default: the 20,000-block chain of 21x10 blocks overlapping 4 columns).
Prints one JSON line; the raw trace stays under DIR.
"""
import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from bench import peak_hbm_bytes_per_s  # noqa: E402
from qrkit_tpu.runtime import card_info, enable_compile_cache, require_gpu  # noqa: E402

FAC_STAGES = ["extract", "phase1", "phase2_apply", "caqr", "boundary_chain"]
SOL_STAGES = [
    "interior_qt", "boundary_qt", "boundary_backsub", "interior_rhs",
    "interior_backsub",
]


def banded_matrix(nb, br, bc, ov, rng):
    from qrkit_tpu.sparse import SparseCSR

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


def _nbytes(tree):
    import jax

    return int(sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(tree)))


def profile(qr, mat, reps, out_dir):
    """Per-stage device ms of one refactorize and one solve, byte floors,
    busy share and host-clock medians."""
    import jax
    import jax.numpy as jnp

    from qrkit_tpu.profiling import device_events, stage_device_times, trace

    dtype = jnp.float32
    vals = jnp.asarray(np.asarray(mat.data, np.float32))
    b = jnp.asarray(np.random.default_rng(1).normal(size=mat.nrows), dtype)
    qr.compute(mat)
    assert qr._delegate is None, "plan must take the segmented composition"
    fac, meta = qr._get_factorize_fn(), qr._fac_meta
    qr.solve(b)
    sol, smeta = qr._solve_fn, qr._sol_meta
    fargs = (qr._Yws, qr._Ts, qr._Yb, qr._Tb, qr._chain_seq, qr._chain_r,
             qr._j2_top, qr._r_panels)

    def fac_step():
        return jax.block_until_ready(fac(vals, meta))

    def sol_step():
        return jax.block_until_ready(sol(*fargs, b, smeta))

    host = {}
    for name, step in (("refactorize", fac_step), ("solve", sol_step)):
        step()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            step()
            ts.append(time.perf_counter() - t0)
        host[name] = statistics.median(ts) * 1e3

    with trace(out_dir):
        for _ in range(reps):
            fac_step()
            sol_step()
    events = device_events(out_dir)
    texts = [fac.lower(vals, meta).compile().as_text(),
             sol.lower(*fargs, b, smeta).compile().as_text()]
    red = stage_device_times(events, texts, FAC_STAGES + SOL_STAGES)

    peak = peak_hbm_bytes_per_s(jax.devices()[0].device_kind)
    out = fac(vals, meta)
    Yws, Ts, Vs, j2_top, Yb, Tb, chain_seq, chain_r, _ = out
    floors = {
        "extract": vals.size * 4,
        "phase1": _nbytes((Yws, Ts, Vs)),
        "phase2_apply": _nbytes((Yws, Ts, j2_top)),
        "caqr": _nbytes((Yb, Tb)),
        "boundary_chain": _nbytes((chain_seq, chain_r)),
        "interior_qt": _nbytes((Yws, Ts)) + b.size * 4,
        "boundary_qt": _nbytes((Yb, Tb, chain_seq)),
        "boundary_backsub": _nbytes(chain_r),
        "interior_rhs": _nbytes(j2_top),
        "interior_backsub": _nbytes(Vs) + mat.ncols * 4,
    }
    stages = {
        st: {
            "device_ms": red["stage_ns"][st] / reps / 1e6,
            "floor_bytes": floors[st],
            "floor_ms": floors[st] / peak * 1e3,
        }
        for st in FAC_STAGES + SOL_STAGES
    }
    return dict(
        stages=stages,
        other_device_ms=red["stage_ns"]["other"] / reps / 1e6,
        busy_share=red["busy_ns"] / red["window_ns"] if red["window_ns"] else None,
        host_median_ms=host,
        top_kernels_ms={k: v / reps / 1e6 for k, v in list(red["kernels_ns"].items())[:12]},
        unmatched_kernels=len(red["unmatched_ns"]),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("size", nargs="?", default="20000")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/trace_segmented")
    args = ap.parse_args()
    # one trace event per kernel: XLA's command buffers (CUDA graphs) would
    # hide a whole program's kernels behind one event
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
    ).strip()
    enable_compile_cache()
    require_gpu()
    import jax

    from qrkit_tpu.solvers import SegmentedBandedQR

    if args.size == "config3":
        # BASELINE.json config 3: 99,960 x 10,000, 40x8 blocks overlapping 4
        nb, br, bc, ov = 2499, 40, 8, 4
    else:
        nb, br, bc, ov = int(args.size), 21, 10, 4
    mat = banded_matrix(nb, br, bc, ov, np.random.default_rng(0))
    qr = SegmentedBandedQR(suggested_block_cols=bc, segment_blocks=32)
    res = profile(qr, mat, args.reps, f"{args.out}_{args.size}")
    print(json.dumps(dict(
        size=args.size, nblocks=nb, shape=[mat.nrows, mat.ncols],
        S=qr.S, L=qr.L, card=card_info(), device=jax.devices()[0].device_kind,
        **res,
    )), flush=True)


if __name__ == "__main__":
    main()
