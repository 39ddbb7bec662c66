"""Command-line entry point: structured sparse QR on MatrixMarket files.

Usage::

    python -m qrkit_tpu A.mtx                     # analyze + factorize, report
    python -m qrkit_tpu A.mtx -b b.mtx -o x.mtx   # least-squares solve
    python -m qrkit_tpu A.mtx --export-r R.mtx --export-q Q.mtx
    python -m qrkit_tpu A.mtx --solver banded --suggested-block-cols 8

The solver stack is chosen by :func:`qrkit_tpu.auto_qr` unless ``--solver``
forces one.  Reports the selection, shape, rank, factorization health
(``info()``) and timings on stderr; writes results as MatrixMarket.  The
reference library has no executable at all (header-only; its tests/benches
are the only drivers) — this is the missing "just run it on my matrix" tool.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _build_parser():
    p = argparse.ArgumentParser(
        prog="python -m qrkit_tpu",
        description="Structured sparse QR on MatrixMarket files.",
    )
    p.add_argument("matrix", help="MatrixMarket file of A")
    p.add_argument("-b", "--rhs", help="MatrixMarket/plain-text RHS vector b")
    p.add_argument("-o", "--out", help="write the solution x (MatrixMarket)")
    p.add_argument("--export-r", help="write sparse R (MatrixMarket)")
    p.add_argument("--export-q", help="write sparse Q (MatrixMarket)")
    p.add_argument(
        "--solver",
        choices=["auto", "block-diagonal", "banded", "segmented", "thin", "dense"],
        default="auto",
        help="force a solver stack (default: auto-select from structure)",
    )
    p.add_argument("--suggested-block-cols", type=int, default=8)
    p.add_argument(
        "--rhs-random",
        action="store_true",
        help="solve against b = A x_true for a random x_true and report the "
        "recovery error (round-trip check)",
    )
    return p


def _load_rhs(path: str, nrows: int) -> np.ndarray:
    if path.endswith(".mtx"):
        from .sparse import load_matrix_market

        m = load_matrix_market(path)
        d = m.to_dense()
        return d[:, 0] if d.ndim == 2 else d
    return np.loadtxt(path).reshape(-1)[:nrows]


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    import jax.numpy as jnp

    from . import auto_qr
    from .solvers import (
        BandedBlockedQR,
        BlockedThinSparseQR,
        ComputationInfo,
        DenseColPivQR,
        SegmentedBandedQR,
    )
    from .auto import BlockDiagonalCSRQR
    from .sparse import SparseCSR, load_matrix_market, save_matrix_market

    t0 = time.perf_counter()
    mat = load_matrix_market(args.matrix)
    print(
        f"loaded {args.matrix}: {mat.nrows}x{mat.ncols}, nnz={mat.nnz}",
        file=sys.stderr,
    )

    t1 = time.perf_counter()
    if args.solver == "auto":
        qr = auto_qr(mat, suggested_block_cols=args.suggested_block_cols)
        selection = qr.selection
    else:
        cls = {
            "block-diagonal": lambda: BlockDiagonalCSRQR(args.suggested_block_cols),
            "banded": lambda: BandedBlockedQR(
                suggested_block_cols=args.suggested_block_cols
            ),
            "segmented": lambda: SegmentedBandedQR(
                suggested_block_cols=args.suggested_block_cols
            ),
            "thin": BlockedThinSparseQR,
            "dense": DenseColPivQR,
        }[args.solver]
        qr = cls().compute(mat)
        selection = args.solver
    t2 = time.perf_counter()

    info = qr.info()
    print(
        f"solver={selection} rank={qr.rank}/{qr.cols} info={info.name} "
        f"(load {t1 - t0:.3f}s, factorize {t2 - t1:.3f}s)",
        file=sys.stderr,
    )
    rc = 0 if info == ComputationInfo.SUCCESS else 2

    b = None
    x_true = None
    if args.rhs_random:
        rng = np.random.default_rng(0)
        x_true = rng.normal(size=mat.ncols)
        b = mat.matvec(x_true)
    elif args.rhs:
        b = _load_rhs(args.rhs, mat.nrows)

    if b is not None:
        t3 = time.perf_counter()
        pb = jnp.asarray(qr.rows_permutation().apply(b))
        x = np.asarray(qr.solve(pb))
        t4 = time.perf_counter()
        resid = np.linalg.norm(mat.matvec(x) - b) / max(np.linalg.norm(b), 1e-300)
        msg = f"solve {t4 - t3:.3f}s, relative residual {resid:.3e}"
        if x_true is not None:
            msg += f", x recovery rel err {np.linalg.norm(x - x_true) / np.linalg.norm(x_true):.3e}"
        print(msg, file=sys.stderr)
        if args.out:
            save_matrix_market(
                args.out,
                SparseCSR.from_triplets(
                    np.arange(x.size), np.zeros(x.size, dtype=np.int64), x,
                    (x.size, 1),
                ),
            )
            print(f"wrote {args.out}", file=sys.stderr)

    if args.export_r:
        save_matrix_market(args.export_r, qr.matrix_r_sparse())
        print(f"wrote {args.export_r}", file=sys.stderr)
    if args.export_q:
        save_matrix_market(args.export_q, qr.matrix_q_sparse())
        print(f"wrote {args.export_q}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    from .runtime import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
