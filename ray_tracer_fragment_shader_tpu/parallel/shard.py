"""Sharded rendering and gradient reduction via shard_map.

Pixel tiles shard across the mesh; the scene/camera pytrees are replicated.
Forward needs no communication at all (tiles are independent); backward
all-reduces the replicated-parameter gradients with ``psum`` — the
counterpart of the reference's (absent) multi-process story (SURVEY.md
section 2.3).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import RenderConfig
from ..core.renderer import render_pixels
from ..ops.rays import Camera, screen_points
from ..scene.flat import FlatScene
from .mesh import TILE_AXIS, make_mesh


def _pixel_index_arrays(width: int, height: int, n_shards: int):
    """Flat (i, j) pixel index arrays padded to a multiple of n_shards.
    Padding pixels are rendered (cheap, they trace the same scene) and
    dropped on reshape."""
    total = width * height
    pad = (-total) % n_shards
    idx = jnp.arange(total + pad, dtype=jnp.int32)
    idx = jnp.minimum(idx, total - 1)  # clamp padding to the last real pixel
    ii = idx % width
    jj = idx // width
    return ii, jj, total


def band_rows(width: int, height_shard: int, axis: str = TILE_AXIS):
    """This shard's row-band pixel indices (call inside shard_map):
    returns flat ``(ii, jj)`` index arrays of shape [height_shard*width]
    for global rows ``[k*height_shard, (k+1)*height_shard)`` where ``k`` is
    this device's position on ``axis``."""
    k = jax.lax.axis_index(axis)
    jj = k * height_shard + jnp.arange(height_shard)
    jj2, ii2 = jnp.meshgrid(jj, jnp.arange(width), indexing="ij")
    return ii2.reshape(-1), jj2.reshape(-1)


def band_split(height: int, n_shards: int):
    """(padded height, rows per shard) for row-band sharding."""
    h_pad = -(-height // n_shards) * n_shards
    return h_pad, h_pad // n_shards


def render_image_sharded(scene: FlatScene, camera: Camera,
                         config: RenderConfig, mesh: Optional[Mesh] = None,
                         axis: str = TILE_AXIS, backend: str = "core",
                         interpret: Optional[bool] = None):
    """Full-frame render with pixel tiles sharded over the mesh -> [H,W,3].

    ``backend="core"`` shards flat pixel indices through the XLA renderer;
    ``backend="pallas"`` shards the image into contiguous row bands, each
    rendered by the Pallas forward kernel on its device.  Forward needs no
    collectives either way.

    The result is produced as a sharded global array; multi-host callers
    keep it device-local (only fetch for preview/IO).
    """
    mesh = make_mesh() if mesh is None else mesh
    n = mesh.devices.size

    if backend == "pallas":
        from ..kernels.render_pallas import render_image_pallas
        h, w = config.height, config.width
        h_pad, h_shard = band_split(h, n)
        cfg_s = dataclasses.replace(config, height=h_shard)

        @functools.partial(shard_map, mesh=mesh, in_specs=(P(),),
                           out_specs=P(axis), check_vma=False)
        def band_render(scene):
            ii, jj = band_rows(w, h_shard, axis)
            pts = screen_points(camera, w, h_shard, ij=(ii, jj))
            return render_image_pallas(scene, camera, cfg_s,
                                       interpret=interpret, pts=pts)

        return band_render(scene)[:h]

    ii, jj, total = _pixel_index_arrays(config.width, config.height, n)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=P(axis), check_vma=False)
    def tile_render(scene, camera, ii, jj):
        return render_pixels(scene, camera, config.width, config.height,
                             config, ij=(ii, jj))

    flat = tile_render(scene, camera, ii, jj)
    return flat[:total].reshape(config.height, config.width, 3)


def sharded_value_and_grad(loss_fn, mesh: Optional[Mesh] = None,
                           axis: str = TILE_AXIS):
    """Wrap a per-shard loss ``loss_fn(params, shard_batch) -> scalar`` into
    a mesh-wide value_and_grad with psum'd loss and gradients.

    ``params`` is replicated; ``shard_batch`` pytree is sharded along its
    leading axis.  The psum of parameter gradients is the single collective
    of the training step (overlapped with backward compute by XLA).
    """
    mesh = make_mesh() if mesh is None else mesh

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(), P(axis)), out_specs=(P(), P()),
                       check_vma=False)
    def vg(params, batch):
        value, grads = jax.value_and_grad(loss_fn)(params, batch)
        value = jax.lax.pmean(value, axis)
        grads = jax.lax.pmean(grads, axis)
        return value, grads

    return vg
