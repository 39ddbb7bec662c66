"""Banded-family benchmark: plain chain vs segmented composition, one chip.

Reproduces the README's banded measurement (the reference's
BandedBlockedSparseQR workload shape: a 34,986x10,000 banded Jacobian of
21x10 blocks overlapping by 4 columns — test 1-3 scaled up,
/root/reference/test/test-qrkit.cpp:218-255) and prints one JSON line per
solver with steady-state factorize/solve walltimes plus a host/device split
of the factorize (the LM pattern re-factorizes one structure per iteration,
so warm per-compute cost is THE number that matters).

Usage: python examples/bench_banded.py [nblocks] [reps]
"""
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")
from bench import peak_hbm_bytes_per_s  # noqa: E402
from qrkit_tpu.runtime import enable_compile_cache, require_gpu  # noqa: E402
from qrkit_tpu.solvers import BandedBlockedQR, SegmentedBandedQR  # noqa: E402
from qrkit_tpu.sparse import SparseCSR  # noqa: E402

BR, BC, OV = 21, 10, 4
STEP = BC - OV


def _factor_bytes(qr) -> int:
    """HBM bytes of the factor state one factorize writes (and one solve
    reads back): compact-WY Y/T stores + R panels (+ the segmented solver's
    boundary-chain factors and index maps).  This is the roofline-minimum
    traffic — actual kernels may move more, never less."""
    inner = qr._delegate if getattr(qr, "_delegate", None) is not None else qr
    if hasattr(inner, "_apply_factors"):  # segmented (non-delegated)
        leaves = jax.tree_util.tree_leaves(inner._apply_factors())
        leaves.append(inner._r_panels)
    else:  # plain banded chain (Yf/Tf: the flattened compact-WY leaves)
        leaves = [inner.q_seq.Yf, inner.q_seq.Tf, inner._r_panels_f]
    return int(sum(np.prod(x.shape) * x.dtype.itemsize for x in leaves))


def banded_matrix(nb: int, rng) -> SparseCSR:
    ncols = STEP * nb + OV
    i = np.arange(nb)[:, None, None]
    r = np.arange(BR)[None, :, None]
    c = np.arange(BC)[None, None, :]
    rows = np.broadcast_to(i * BR + r, (nb, BR, BC)).ravel()
    cols = np.broadcast_to(i * STEP + c, (nb, BR, BC)).ravel()
    keep = cols < ncols
    vals = rng.uniform(0.5, 5.0, size=rows.size)
    return SparseCSR.from_triplets(
        rows[keep], cols[keep], vals[keep], (BR * nb, ncols)
    )


def _fetch_scalar(x):
    """Wait for the device: programs run in dispatch order, so waiting on
    the LAST result fences every earlier dispatch too."""
    jax.block_until_ready(x)


def bench(qr, mat, b, reps):
    """Steady-state per-op walltime via the difference quotient
    ``(T(reps) - T(1)) / (reps - 1)`` — cancels the fixed dispatch/fetch
    round trip.  Every rep gets FRESH data values (scaled copies) so no
    layer can dedup/cache repeated identical work."""
    qr.compute(mat)  # analysis + compile
    qr.compute(mat)
    mats = [
        SparseCSR(mat.shape, mat.indptr, mat.indices, mat.data * (1 + 1e-9 * (k + 1)))
        for k in range(reps)
    ]

    def run_fac(K):
        t0 = time.perf_counter()
        for mk in mats[:K]:
            qr.compute(mk)
        inner = qr._delegate if getattr(qr, "_delegate", None) is not None else qr
        rp = getattr(inner, "_r_panels", None)  # segmented: SoA store
        if rp is None:  # plain banded: flattened store (avoid the padded view)
            rp = getattr(inner, "_r_panels_f", inner.r_panels)
        _fetch_scalar(rp)
        return time.perf_counter() - t0

    run_fac(1)
    fac = (run_fac(reps) - run_fac(1)) / (reps - 1)

    def _r_store():
        inner = qr._delegate if getattr(qr, "_delegate", None) is not None else qr
        rp = getattr(inner, "_r_panels", None)
        return rp if rp is not None else getattr(inner, "_r_panels_f", inner.r_panels)

    # device-resident refactorize (factorize_values): the on-device LM
    # pattern, where the Jacobian values are produced by a jitted function
    # and never touch the host — isolates the solver's own device cost from
    # the host astype + upload that the host-fed number includes
    vals0 = jnp.asarray(np.asarray(mat.data, np.float32))
    qr.factorize_values(vals0)
    _fetch_scalar(_r_store())

    def run_refac(K):
        t0 = time.perf_counter()
        v = vals0
        for _ in range(K):
            v = v * np.float32(1 + 1e-9)  # fresh on-device values per rep
            qr.factorize_values(v)
        _fetch_scalar(_r_store())
        return time.perf_counter() - t0

    run_refac(1)
    refac = (run_refac(reps) - run_refac(1)) / (reps - 1)

    bs = [b * (1 + 1e-9 * (k + 1)) for k in range(reps)]
    x = qr.solve(b)
    _fetch_scalar(x)

    def run_sol(K):
        t0 = time.perf_counter()
        for bk in bs[:K]:
            xk = qr.solve(bk)
        _fetch_scalar(xk)
        return time.perf_counter() - t0

    run_sol(1)
    sol = (run_sol(reps) - run_sol(1)) / (reps - 1)
    return fac, refac, sol, qr.solve(b)


def main():
    global BR, BC, OV, STEP
    enable_compile_cache()
    require_gpu()
    args = sys.argv[1:]
    if args and args[0] == "config3":
        # BASELINE.json config 3, literal shape: ~100k x 10k banded matrix,
        # row bandwidth 8 (40x8 blocks overlapping 4 -> 99,960 x 10,000)
        BR, BC, OV = 40, 8, 4
        STEP = BC - OV
        nb = 2499
        reps = int(args[1]) if len(args) > 1 else 5
    else:
        nb = int(args[0]) if args else 1666
        reps = int(args[1]) if len(args) > 1 else 5
    rng = np.random.default_rng(0)
    mat = banded_matrix(nb, rng)
    x_true = rng.normal(size=mat.ncols)
    # avoid a dense [m, n] product at huge sizes — but keep the RHS random so
    # the solve timing never runs on a degenerate all-zero vector
    small = mat.nrows * mat.ncols <= 50_000_000
    b = jnp.asarray(
        mat.to_dense() @ x_true if small else rng.normal(size=mat.nrows)
    )
    print(f"# matrix {mat.nrows}x{mat.ncols}, nnz={mat.data.size}", file=sys.stderr)

    peak_bw = peak_hbm_bytes_per_s(jax.devices()[0].device_kind)
    itemsize = 8 if jax.config.jax_enable_x64 else 4
    for name, qr in [
        ("banded_plain", BandedBlockedQR(suggested_block_cols=BC)),
        ("banded_segmented", SegmentedBandedQR(suggested_block_cols=BC, segment_blocks=32)),
    ]:
        fac, refac, sol, x = bench(qr, mat, b, reps)
        resid = None
        if small:
            xh = np.asarray(x, dtype=np.float64)
            resid = float(np.linalg.norm(xh - x_true) / np.linalg.norm(x_true))
        # roofline per stage (VERDICT r2 item 7): device-resident refactorize
        # reads the value vector and writes the factors; a solve reads the
        # factors + b and writes x.  The host-fed factorize stage includes
        # host assembly + upload, so an HBM fraction would be meaningless
        # there — its honest absolute measure is refactorize.
        fbytes = _factor_bytes(qr)
        refac_bytes = mat.data.size * itemsize + fbytes
        solve_bytes = fbytes + (mat.nrows + mat.ncols) * itemsize
        print(json.dumps({
            "solver": name,
            "nblocks": nb,
            "factorize_ms": fac * 1e3,
            "refactorize_device_ms": refac * 1e3,
            "solve_ms": sol * 1e3,
            "refactorize_bytes_moved": refac_bytes,
            "refactorize_hbm_frac": refac_bytes / refac / peak_bw,
            "solve_bytes_moved": solve_bytes,
            "solve_hbm_frac": solve_bytes / sol / peak_bw,
            "rel_err": resid,
            "device": jax.devices()[0].device_kind,
        }))


if __name__ == "__main__":
    main()
