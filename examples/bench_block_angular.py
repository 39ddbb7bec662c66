"""Block-angular solver benchmark on the reference's own workload shape.

Times `BlockAngularQR(BlockDiagonalQR 2x1 left, DenseColPivQR right)` —
factorize (host-fed), device-resident refactorize, and solve — plus the fused
`functional.block_angular_lstsq` damped-step program, on the ellipse Jacobian
shape the same-machine reference baseline uses:
``[J1 | J2]`` with J1 = 2N x N block-diagonal of 2x1 blocks, J2 = 2N x 5
dense (`native/qrkit_reference_extra.cpp blockangular`,
/root/reference/src/QRKit/BlockAngularSparseQR.h:458-514; measured numbers in
`bench_baseline.json` -> `reference_qrkit_blockangular_measured`).

Timing: steady-state per-op walltime via the difference-of-two-rep-counts
quotient (it cancels fixed per-call overhead), fresh data values every rep,
and ``block_until_ready`` on the LAST result as the fence.

Usage: python examples/bench_block_angular.py [N ...] [--reps R]
Prints one JSON line per N.
"""
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")
from bench import peak_hbm_bytes_per_s  # noqa: E402
from qrkit_tpu.containers import BlockDiagonal, BlockMatrix1x2  # noqa: E402
from qrkit_tpu.functional import block_angular_lstsq  # noqa: E402
from qrkit_tpu.runtime import enable_compile_cache, require_gpu  # noqa: E402
from qrkit_tpu.solvers import (  # noqa: E402
    BlockAngularQR,
    BlockDiagonalQR,
    DenseColPivQR,
)
from qrkit_tpu.solvers.block_diagonal import QFormat  # noqa: E402

M2 = 5  # dense right-block columns (the ellipse Jacobian's angular params)


def _fetch(x):
    jax.block_until_ready(x)


def _quotient(run, reps):
    run(1)  # warm
    t1 = run(1)
    tk = run(reps)
    return (tk - t1) / (reps - 1)


def make_problem(N, rng, dtype):
    blocks = rng.uniform(0.5, 5.0, size=(N, 2, 1)).astype(dtype)
    a2 = rng.uniform(0.5, 5.0, size=(2 * N, M2)).astype(dtype)
    xt = rng.normal(size=N + M2).astype(dtype)
    b = np.zeros(2 * N, dtype)
    b[0::2] = blocks[:, 0, 0] * xt[:N]
    b[1::2] = blocks[:, 1, 0] * xt[:N]
    b += a2 @ xt[N:]
    return blocks, a2, b, xt


def _solver():
    return BlockAngularQR(
        BlockDiagonalQR(QFormat.FULL_Q, pivot=False), DenseColPivQR()
    )


def _factor_bytes(qr):
    qr.left._ensure_dense_factors()
    leaves = [qr.left.Q, qr.left.R, qr._r12]
    r = qr.right.inner if hasattr(qr.right, "inner") else qr.right
    leaves += [r._Y, r._T, r._R]
    return int(sum(np.prod(x.shape) * x.dtype.itemsize for x in leaves))


def bench_one(N, reps, rng):
    dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
    blocks, a2, b, xt = make_problem(N, rng, dtype)
    blocks_d = jnp.asarray(blocks)
    a2_d = jnp.asarray(a2)
    b_d = jnp.asarray(b)

    qr = _solver()
    qr.compute(BlockMatrix1x2(BlockDiagonal(blocks_d, 2 * N, N), a2_d))
    qr.compute(BlockMatrix1x2(BlockDiagonal(blocks_d, 2 * N, N), a2_d))

    def _r_probe(q):
        r = q.right.inner if hasattr(q.right, "inner") else q.right
        return r._R

    # host-fed factorize: fresh host values every rep (upload included) —
    # the apples-to-apples column against the reference's compute() walltime
    host_mats = [
        (blocks * (1 + 1e-9 * (k + 1)), a2 * (1 + 1e-9 * (k + 1)))
        for k in range(reps)
    ]

    def run_fac(K):
        t0 = time.perf_counter()
        for bk, ak in host_mats[:K]:
            qr.compute(
                BlockMatrix1x2(
                    BlockDiagonal(jnp.asarray(bk), 2 * N, N), jnp.asarray(ak)
                )
            )
        _fetch(_r_probe(qr))
        return time.perf_counter() - t0

    fac = _quotient(run_fac, reps)

    # device-resident refactorize: values produced on device (the LM
    # pattern), compute() stays fetch-free so the chain never blocks
    def run_refac(K):
        t0 = time.perf_counter()
        bk, ak = blocks_d, a2_d
        for _ in range(K):
            bk = bk * dtype(1 + 1e-9)
            ak = ak * dtype(1 + 1e-9)
            qr.compute(BlockMatrix1x2(BlockDiagonal(bk, 2 * N, N), ak))
        _fetch(_r_probe(qr))
        return time.perf_counter() - t0

    refac = _quotient(run_refac, reps)

    def run_sol(K):
        t0 = time.perf_counter()
        bb = b_d
        for _ in range(K):
            bb = bb * dtype(1 + 1e-9)
            x = qr.solve(bb)
        _fetch(x)
        return time.perf_counter() - t0

    sol = _quotient(run_sol, reps)

    # fused one-program damped-step (functional.block_angular_lstsq): the
    # production LM path — solver-stack work as ONE compiled dispatch
    fused = jax.jit(lambda blk, a, bb: block_angular_lstsq(blk, a, bb, tail=0))
    fused(blocks_d, a2_d, b_d).block_until_ready()

    def run_fused(K):
        t0 = time.perf_counter()
        bk = blocks_d
        for _ in range(K):
            bk = bk * dtype(1 + 1e-9)
            x = fused(bk, a2_d, b_d)
        _fetch(x)
        return time.perf_counter() - t0

    fus = _quotient(run_fused, reps)

    # lane-major resident path: SoA left blocks + transposed right block
    from qrkit_tpu.containers import BlockDiagonal as _BD

    soa0 = jnp.asarray(
        np.ascontiguousarray(blocks.transpose(1, 2, 0).reshape(2, N))
    )
    a2t0 = jnp.asarray(np.ascontiguousarray(a2.T))
    qs = _solver()

    def mk_soa(s, at):
        return BlockMatrix1x2(
            _BD.from_soa(s, 2, 1, nrows=2 * N), at, right_t=True
        )

    qs.compute(mk_soa(soa0, a2t0))
    assert qs._fused_soa, "SoA fused path must engage"
    qs.compute(mk_soa(soa0, a2t0))

    # protocol walltime (eager per-call dispatches):
    def run_refac_soa(K):
        t0 = time.perf_counter()
        s, at = soa0, a2t0
        for _ in range(K):
            s = s * dtype(1 + 1e-9)
            at = at * dtype(1 + 1e-9)
            qs.compute(mk_soa(s, at))
        _fetch(qs._sR2)
        return time.perf_counter() - t0

    refac_soa_protocol = _quotient(run_refac_soa, reps)

    # device-side steady state of the SAME programs, scan-chained with a
    # data dependency, so per-call dispatch overhead drops out:
    import functools as _ft

    from qrkit_tpu.solvers.block_angular_fused import (
        fused_soa_compute,
        fused_soa_compute_solve,
        fused_soa_solve,
    )

    fkw = dict(br=2, bc=1, colpiv=True, aos=False, a2_aos=False)

    @_ft.partial(jax.jit, static_argnames=("iters",))
    def ch_fac(soa, a2t, iters):
        def body(c, _):
            out = fused_soa_compute(soa * c, a2t, **fkw)
            return 1.0 + 1e-12 * out[6][0, 0], None

        f, _ = jax.lax.scan(
            body, jnp.asarray(1.0, dtype), None, length=iters, unroll=4
        )
        return f

    sfac = qs._sU1, qs._sc1, qs._sR1, qs._sU2, qs._sc2, qs._sR2
    perm2, r12t = qs._fused_perm2, qs._sr12t

    @_ft.partial(jax.jit, static_argnames=("iters",))
    def ch_sol(b, iters):
        def body(c, _):
            x = fused_soa_solve(
                sfac[0], sfac[1], sfac[2], sfac[3], sfac[4], sfac[5],
                perm2, r12t, b * c, colpiv=True,
            )
            return 1.0 + 1e-12 * x[0], None

        f, _ = jax.lax.scan(
            body, jnp.asarray(1.0, dtype), None, length=iters, unroll=4
        )
        return f

    @_ft.partial(jax.jit, static_argnames=("iters",))
    def ch_cs(soa, a2t, b, iters):
        def body(c, _):
            out = fused_soa_compute_solve(soa * c, a2t, b, **fkw)
            return 1.0 + 1e-12 * out[-1][0], None

        f, _ = jax.lax.scan(
            body, jnp.asarray(1.0, dtype), None, length=iters, unroll=4
        )
        return f

    def _scan_quotient(fn, args, lo, hi):
        def wall(iters, r=3):
            _fetch(fn(*args, iters=iters))
            best = float("inf")
            for _ in range(r):
                t0 = time.perf_counter()
                _fetch(fn(*args, iters=iters))
                best = min(best, time.perf_counter() - t0)
            return best

        return (wall(hi) - wall(lo)) / (hi - lo)

    lo, hi = (1000, 9000) if N <= 20_000 else (100, 900)
    refac_soa = _scan_quotient(ch_fac, (soa0, a2t0), lo, hi)
    sol_soa = _scan_quotient(ch_sol, (b_d,), lo, hi)
    cs_soa = _scan_quotient(ch_cs, (soa0, a2t0, b_d), lo, hi)

    x_soa_sol = np.asarray(qs.solve(b_d), np.float64)

    x = np.asarray(qr.solve(b_d), np.float64)
    num = np.zeros(2 * N)
    num[0::2] = blocks[:, 0, 0] * x[:N]
    num[1::2] = blocks[:, 1, 0] * x[:N]
    num += a2 @ x[N:]
    rel = float(np.linalg.norm(num - b) / np.linalg.norm(b))
    rel_soa = float(
        np.linalg.norm(x_soa_sol - x) / max(np.linalg.norm(x), 1e-30)
    )

    peak_bw = peak_hbm_bytes_per_s(jax.devices()[0].device_kind)
    isz = np.dtype(dtype).itemsize
    fbytes = _factor_bytes(qr)
    in_bytes = blocks.size * isz + a2.size * isz
    refac_bytes = in_bytes + fbytes
    solve_bytes = fbytes + (2 * N + N + M2) * isz
    # SoA-path roofline: same logical bytes (values in + lane-major factor
    # stores out)
    soa_factors = [qs._sU1, qs._sc1, qs._sR1, qs._sU2, qs._sc2, qs._sR2,
                   qs._sr12t]
    soa_fbytes = int(
        sum(np.prod(x.shape) * x.dtype.itemsize for x in soa_factors)
    )
    refac_soa_bytes = in_bytes + soa_fbytes
    solve_soa_bytes = soa_fbytes + (2 * N + N + M2) * isz
    return {
        "N": N,
        "rows": 2 * N,
        "cols": N + M2,
        "factorize_ms": fac * 1e3,
        "refactorize_device_ms": refac * 1e3,
        "solve_ms": sol * 1e3,
        "fused_lstsq_ms": fus * 1e3,
        "refactorize_soa_ms": refac_soa * 1e3,
        "solve_soa_ms": sol_soa * 1e3,
        "compute_solve_soa_ms": cs_soa * 1e3,
        "refactorize_soa_protocol_ms": refac_soa_protocol * 1e3,
        "refactorize_bytes_moved": refac_bytes,
        "refactorize_hbm_frac": refac_bytes / refac / peak_bw,
        "refactorize_soa_hbm_frac": refac_soa_bytes / refac_soa / peak_bw,
        "solve_bytes_moved": solve_bytes,
        "solve_hbm_frac": solve_bytes / sol / peak_bw,
        "solve_soa_hbm_frac": solve_soa_bytes / sol_soa / peak_bw,
        "rel_resid": rel,
        "rel_soa_vs_aos": rel_soa,
        "device": jax.devices()[0].device_kind,
    }


def main():
    enable_compile_cache()
    require_gpu()
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    reps = 8
    for a in sys.argv[1:]:
        if a.startswith("--reps"):
            reps = int(a.split("=")[1])
    sizes = [int(a) for a in args] or [500, 10_000, 100_000, 500_000]
    rng = np.random.default_rng(0)
    for N in sizes:
        print(json.dumps(bench_one(N, reps, rng)), flush=True)


if __name__ == "__main__":
    main()
