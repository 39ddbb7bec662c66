"""Process set-up shared by the command-line entry points.

Nothing here runs on import: ``chip_smoke.py``, ``bench.py``, the scripts in
``examples/`` and ``python -m qrkit_tpu`` call these helpers themselves.
"""
from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

__all__ = ["CACHE_DIR", "card_info", "enable_compile_cache", "require_gpu"]

# Fixed per checkout: the cache key includes the directory, so a moving
# path (a temp name, a pid, the time) would never hit.
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing; otherwise the cache goes to ``<checkout>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def require_gpu() -> None:
    """Exit non-zero unless JAX's first device is a GPU: a measurement or
    on-card check never falls back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform} ({dev.device_kind})"
        )


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
