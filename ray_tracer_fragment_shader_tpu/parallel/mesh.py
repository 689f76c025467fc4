"""Device-mesh helpers.

The reference is a single-threaded CPU loop (SURVEY.md 2.3); the
scaling dimension is pixel-tile data parallelism over a ``jax.sharding.Mesh``
with replicated scene parameters — rays are embarrassingly parallel, the only
cross-device reductions are gradient psums in the backward pass.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def make_mesh(devices: Optional[Sequence] = None, axis: str = TILE_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices; pixel tiles shard along it.

    With several hosts, call ``jax.distributed.initialize()`` first;
    ``jax.devices()`` then spans all hosts and the same SPMD code runs
    per-host (no per-rank code paths, SURVEY.md section 4 item 3).
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    return Mesh(np.array(devices), (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, axis: str = TILE_AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis))
