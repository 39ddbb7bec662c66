"""Block-diagonal factorize+solve on the card: the fused Triton kernel against
the two plain versions XLA compiles.

For 7×2 fp32 blocks at each size it times one ``compute`` plus one vector
``solve`` through ``BlockDiagonalQR`` with the kernel (``use_pallas=True``)
and with the vmapped compact-WY path (``use_pallas=False``), and the same
per-block recurrence written in ``jax.numpy``
(``ops.pallas_blockdiag.block_rdiag_jnp`` + ``block_lstsq_jnp``), which XLA
fuses on its own.  Each number is the median host-clock time of ``REPS``
steps ended by ``block_until_ready``, after a warm-up that compiles.  Every
path's solution is checked against a NumPy fp64 solve of the same blocks.
``--sweep`` also times the kernel's solve at other lane counts and warp
counts.  ``--trace DIR`` records a profiler trace of each path's steps
(with XLA's command buffers off, so every kernel is its own trace event) and
reports device time per step, summed over the programs each step runs.

Usage: python examples/bench_blockdiag_paths.py [NBLOCKS ...] [--sweep] [--trace DIR]
Prints one JSON line per size.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, ".")
from bench import time_step  # noqa: E402
from qrkit_tpu.runtime import card_info, enable_compile_cache, require_gpu  # noqa: E402

BR, BC = 7, 2


def _rel_resid(blocks, b, x):
    nb = blocks.shape[0]
    r = np.einsum("bij,bj->bi", blocks, np.asarray(x, np.float64).reshape(nb, BC))
    return float(np.linalg.norm(r.reshape(-1) - b) / np.linalg.norm(b))


def _device_ms(events, reps):
    """Device ms per step by HLO module, from the trace's kernel events."""
    per = {}
    for ev in events:
        mod = str(ev["stats"].get("hlo_module", ev["name"]))
        per[mod] = per.get(mod, 0.0) + ev["dur_ns"] / reps / 1e6
    return per


def run(nb, sweep, trace_dir=None):
    import jax
    import jax.numpy as jnp

    from qrkit_tpu import BlockDiagonal, BlockDiagonalQR, QFormat
    from qrkit_tpu.ops import pallas_blockdiag as K

    rng = np.random.default_rng(0)
    blocks = rng.uniform(0.5, 5.0, size=(nb, BR, BC))
    b = np.einsum("bij,bj->bi", blocks, rng.normal(size=(nb, BC))).reshape(-1)
    a_d = jnp.asarray(blocks, jnp.float32)
    b_d = jnp.asarray(b, jnp.float32)
    mat = BlockDiagonal(a_d, nb * BR, nb * BC)
    out = {"nblocks": nb}
    steps = {}
    for name, use in (("triton", True), ("xla", False)):
        qr = BlockDiagonalQR(QFormat.FULL_Q, pivot=False, use_pallas=use)

        def step(qr=qr):
            return jax.block_until_ready(qr.compute(mat).solve(b_d))

        steps[name] = step
        x = step()
        assert qr._pallas_mode is use
        out[f"{name}_compute_solve_ms"] = time_step(step) * 1e3
        out[f"{name}_solve_ms"] = time_step(
            lambda qr=qr: jax.block_until_ready(qr.solve(b_d))
        ) * 1e3
        out[f"{name}_rel_resid"] = _rel_resid(blocks, b, x)

    b2 = b_d.reshape(nb, BR)

    def jnp_step():
        return jax.block_until_ready(
            (K.block_rdiag_jnp(a_d, BR), K.block_lstsq_jnp(a_d, b2))
        )

    steps["jnp"] = jnp_step
    out["jnp_compute_solve_ms"] = time_step(jnp_step) * 1e3
    out["jnp_rel_resid"] = _rel_resid(blocks, b, jnp_step()[1])

    if trace_dir:
        from qrkit_tpu.profiling import device_events, trace

        reps = 20
        for name, step in steps.items():
            d = f"{trace_dir}/{name}_{nb}"
            with trace(d):
                for _ in range(reps):
                    step()
            per = _device_ms(device_events(d), reps)
            out[f"{name}_device_ms"] = sum(per.values())
            out[f"{name}_device_ms_by_program"] = per

    if sweep:
        for lanes in (128, 256, 512, 1024):
            for warps in (2, 4, 8):
                K._LANES, K._NUM_WARPS = lanes, warps
                jax.clear_caches()

                def kstep():
                    return jax.block_until_ready(K.block_lstsq(a_d, b_d, BR))

                x = kstep()
                out[f"kernel_solve_ms_l{lanes}_w{warps}"] = time_step(kstep) * 1e3
                out[f"kernel_rel_resid_l{lanes}_w{warps}"] = _rel_resid(blocks, b, x)
    return out


def main():
    argv = sys.argv[1:]
    trace_dir = None
    if "--trace" in argv:
        i = argv.index("--trace")
        trace_dir = argv[i + 1]
        del argv[i : i + 2]
        # one trace event per kernel: XLA's command buffers (CUDA graphs)
        # would hide the kernels of a step behind one event
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
        ).strip()
    args = [a for a in argv if not a.startswith("--")]
    sweep = "--sweep" in argv
    enable_compile_cache()
    require_gpu()
    import jax

    card = card_info()
    for nb in [int(a) for a in args] or [10_000, 1_000_000]:
        res = run(nb, sweep, trace_dir)
        res.update(card=card, device=jax.devices()[0].device_kind)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
