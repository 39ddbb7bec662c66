"""chip_smoke.py on the CPU backend: each phase at a tiny size against its
plain reference, the refusal to run without a GPU, and the matmul-precision
audit of every main path (a float32 product outside a highest-precision scope
runs in TF32 on the card, which the CPU cannot show numerically)."""
import contextlib
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

TINY = dict(
    blockdiag=dict(nb=500),
    banded=dict(nb=80),
    block_angular=dict(n=2000),
    ellipse=dict(n=2000, batch=8, batch_n=200),
    bundle=dict(n_pts=300, n_cams=4, iters=10),
)
PHASES = {
    "blockdiag": cs.phase_blockdiag,
    "banded": cs.phase_banded,
    "block_angular": cs.phase_block_angular,
    "ellipse": cs.phase_ellipse,
    "bundle": cs.phase_bundle,
}


@contextlib.contextmanager
def _dot_precisions():
    """Record the precision of every dot_general traced in the block."""
    from jax._src.lax import lax as lax_internal

    prim = lax_internal.dot_general_p
    seen = []
    orig = prim.bind

    def bind(*args, **params):
        seen.append(params.get("precision"))
        return orig(*args, **params)

    jax.clear_caches()  # every program below traces afresh
    prim.bind = bind
    try:
        yield seen
    finally:
        del prim.bind


def _highest(p):
    h = jax.lax.Precision.HIGHEST
    return p is not None and all(x == h for x in (p if isinstance(p, tuple) else (p,)))


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_smoke_phase_tiny_and_full_precision(phase):
    """The phase runs end to end at a tiny size, within the same tolerances
    the card is held to, and every matmul it traces asks for full
    precision."""
    with _dot_precisions() as seen:
        recs = PHASES[phase](**TINY[phase])
    assert recs and all(r["err"] <= r["tol"] for r in recs)
    assert seen, "the phase traced no matmul at all"
    low = [p for p in seen if not _highest(p)]
    assert not low, f"{len(low)} of {len(seen)} matmuls below HIGHEST: {low[:3]}"


def test_smoke_mesh_phase_on_virtual_devices():
    """The four-card phase on four virtual CPU devices: each sharded result
    matches the one-device result and really spans four devices."""
    with _dot_precisions() as seen:
        recs = cs.phase_mesh(nb=800, chain=300, n=800, bundle_pts=200)
    assert seen and all(_highest(p) for p in seen)
    assert {r["check"] for r in recs} >= {
        "blockdiag", "segmented_banded", "block_angular_lstsq", "tsqr_dense",
        "bundle_damped_step",
    }


def test_smoke_refuses_cpu():
    """No GPU: non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=root, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_smoke_tolerances_have_reasons():
    for key, (tol, why) in cs.TOL.items():
        assert 0 < tol < 1e-3 and why, key
