"""Device-mesh helpers.

The reference's only parallelism is std::thread / OpenMP inside one process
(SURVEY §2.3); the distribution story here is a ``jax.sharding.Mesh``
with the *block axis as the data-parallel axis*: block-diagonal QR is
embarrassingly parallel over blocks, so sharding the leading ``[nb, ...]`` axis
is all XLA's SPMD partitioner needs — collectives only appear where composition
demands them (TSQR all-gathers, LM reductions).
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["default_mesh", "shard_leading_axis"]


def default_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def shard_leading_axis(x, mesh: Mesh, axis: str = "dp"):
    """Place an array (or pytree) with its leading axis sharded over ``axis``."""
    def place(a):
        spec = P(axis, *([None] * (a.ndim - 1)))
        return jax.device_put(a, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(place, x)
