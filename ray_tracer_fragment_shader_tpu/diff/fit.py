"""Differentiable fitting: recover scene parameters from a target image
(BASELINE config 4).

The reference has no training story at all; this is the capability the
"differentiable" in the north star adds: L2 photometric loss + Adam over
sphere centers/radii, light positions, and (optionally) material colors,
with gradients defined through fixed hit topology.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import RenderConfig
from ..core.renderer import render_image, render_pixels
from ..ops.rays import Camera, screen_points
from ..parallel.mesh import TILE_AXIS, make_mesh
from ..parallel.shard import _pixel_index_arrays, band_rows, band_split
from ..scene.flat import FlatScene
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class FitParams:
    """The differentiable subset of the scene (BASELINE: sphere geometry +
    light positions; material color tables included for generality)."""
    sph_center: Any
    sph_radius: Any
    light_pos: Any
    mat_diffuse: Any
    mat_specular: Any
    mat_ambient: Any

    @classmethod
    def from_scene(cls, scene: FlatScene) -> "FitParams":
        return cls(sph_center=scene.sph_center, sph_radius=scene.sph_radius,
                   light_pos=scene.light_pos, mat_diffuse=scene.mat_diffuse,
                   mat_specular=scene.mat_specular, mat_ambient=scene.mat_ambient)

    def into_scene(self, scene: FlatScene) -> FlatScene:
        return scene.replace(
            sph_center=self.sph_center, sph_radius=self.sph_radius,
            light_pos=self.light_pos, mat_diffuse=self.mat_diffuse,
            mat_specular=self.mat_specular, mat_ambient=self.mat_ambient)


def default_fit_optimizer(geom_lr: float = 0.5, light_lr: float = 1.0,
                          mat_lr: float = 0.01) -> optax.GradientTransformation:
    """Adam with per-group learning rates matched to parameter scales:
    world-space geometry (~1e2 units) vs material colors (~1e-1).  A single
    global Adam rate either stalls the geometry or blows up the materials."""
    labels = FitParams(sph_center="geom", sph_radius="geom",
                       light_pos="light", mat_diffuse="mat",
                       mat_specular="mat", mat_ambient="mat")
    return optax.multi_transform(
        {"geom": optax.adam(geom_lr), "light": optax.adam(light_lr),
         "mat": optax.adam(mat_lr)}, labels)


def l2_loss(params: FitParams, scene: FlatScene, camera: Camera,
            config: RenderConfig, target) -> jnp.ndarray:
    img = render_image(params.into_scene(scene), camera, config)
    return jnp.mean((img - target) ** 2)


def make_fit_step(scene: FlatScene, camera: Camera, config: RenderConfig,
                  target, optimizer: optax.GradientTransformation):
    """Single-device jitted Adam step."""

    @jax.jit
    def step(params: FitParams, opt_state):
        loss, grads = jax.value_and_grad(l2_loss)(params, scene, camera,
                                                  config, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_fit_step_pallas(scene: FlatScene, camera: Camera,
                         config: RenderConfig, target,
                         optimizer: optax.GradientTransformation,
                         interpret: Optional[bool] = None):
    """Single-device jitted Adam step on the Pallas path
    (``kernels/adjoint_fused.py::fit_value_and_grad``).

    For single-sample chain scenes the step-invariant padded input planes —
    primary-ray directions, target RGB, pixel mask — are prepared ONCE here
    (``prepare_fit_inputs``) and reused every step; XLA does not hoist them
    out of a training-loop body on its own."""
    from ..kernels.adjoint_fused import (fit_value_and_grad,
                                         prepare_fit_inputs)
    target = jnp.asarray(target, jnp.float32)
    prep = None
    if scene.chain_exact and not (config.samples > 1 or config.force_jitter):
        prep = prepare_fit_inputs(camera, config, target)

    @jax.jit
    def step(params: FitParams, opt_state):
        loss, grads = fit_value_and_grad(
            params, scene, camera, config, target, interpret=interpret,
            prep=prep)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_sharded_fit_step(scene: FlatScene, camera: Camera,
                          config: RenderConfig, target_flat,
                          optimizer: optax.GradientTransformation,
                          mesh: Optional[Mesh] = None, axis: str = TILE_AXIS):
    """Multi-chip training step: pixel tiles sharded over the mesh,
    parameters replicated, the globally-normalized loss/gradients psum'd
    across the mesh (each shard divides by the global pixel count, so the psum is
    exact — no pmean of unequal shard weights), Adam applied identically on
    every device (SPMD).

    ``target_flat``: [H*W (padded to mesh size), 3] target pixels, sharded
    along the leading axis together with the pixel index arrays.

    Padding entries (flat index >= H*W, clamped by ``_pixel_index_arrays``
    to duplicate the last real pixel) are weighted to ZERO in the loss and
    the sum is divided by the true pixel count, so the sharded loss equals
    the unsharded ``l2_loss`` for any H*W, divisible by the mesh or not —
    the same ``row_valid`` masking the Pallas fast path does.
    """
    mesh = make_mesh() if mesh is None else mesh
    n = mesh.devices.size
    ii, jj, total = _pixel_index_arrays(config.width, config.height, n)
    denom = float(total * 3)

    def shard_loss(params: FitParams, batch):
        ii, jj, tgt, valid = batch
        flat = render_pixels(params.into_scene(scene), camera, config.width,
                             config.height, config, ij=(ii, jj))
        d = flat - tgt
        return jnp.sum(valid[:, None] * d * d) / denom

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(), P(), P(axis), P(axis), P(axis)),
                       out_specs=(P(), P(), P()),
                       check_vma=False)
    def sharded_step(params, opt_state, ii, jj, tgt):
        # this shard's global flat positions: entries past the true pixel
        # count are mesh padding (duplicated pixels) -> zero weight
        m = ii.shape[0]
        pos = jax.lax.axis_index(axis) * m + jnp.arange(m)
        valid = (pos < total).astype(jnp.float32)
        loss, grads = jax.value_and_grad(shard_loss)(params,
                                                     (ii, jj, tgt, valid))
        loss = jax.lax.psum(loss, axis)
        grads = jax.lax.psum(grads, axis)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    step = jax.jit(sharded_step)
    return step, (ii, jj)


def make_sharded_fit_step_pallas(scene: FlatScene, camera: Camera,
                                 config: RenderConfig, target_img,
                                 optimizer: optax.GradientTransformation,
                                 mesh: Optional[Mesh] = None,
                                 axis: str = TILE_AXIS,
                                 interpret: Optional[bool] = None):
    """Multi-device training step on the kernel path: each device renders
    its contiguous row band of the image with the packed two-phase kernels
    (forward + in-kernel L2 cotangent + replay adjoint), and the
    ``FitParams`` gradients are all-reduced with one ``psum``.  No naive
    autodiff anywhere.  Chain-exact single-sample scenes only;
    fractional-transparency scenes take ``make_sharded_fit_step``.

    ``target_img``: [H, W, 3] target.  Returns ``(step, target_padded)``
    where ``step(params, opt_state, target_padded) -> (params, opt_state,
    loss)`` and ``target_padded`` is row-padded to the mesh size (shard it
    with ``P(axis)`` placement or pass as-is under jit).

    Matches ``fit_value_and_grad`` (kernels/adjoint_fused.py) up to float
    reassociation of the per-block gradient sums."""
    from ..kernels.adjoint_fused import (grads_to_fitparams,
                                         twophase_loss_grads_pallas)
    if not scene.chain_exact:
        raise ValueError("the sharded kernel step replays the bounce chain; "
                         "fractional-transparency scenes take "
                         "make_sharded_fit_step")

    mesh = make_mesh() if mesh is None else mesh
    n = mesh.devices.size
    h, w = config.height, config.width
    h_pad, h_shard = band_split(h, n)
    cfg_s = dataclasses.replace(config, height=h_shard)
    tgt = jnp.asarray(target_img, jnp.float32)
    if h_pad != h:
        tgt = jnp.concatenate(
            [tgt, jnp.zeros((h_pad - h, w, 3), jnp.float32)], 0)
    denom = float(h * w * 3)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(), P(), P(axis)),
                       out_specs=(P(), P(), P()),
                       check_vma=False)
    def sharded_step(params: FitParams, opt_state, tgt_rows):
        ii, jj = band_rows(w, h_shard, axis)
        pts = screen_points(camera, w, h_shard, ij=(ii, jj))
        # rows >= h are mesh padding: mask their loss/cotangent to zero
        row_valid = (jj < h).reshape(h_shard, w).astype(jnp.float32)
        scene_full = params.into_scene(scene)
        # two kernels per band: forward + packed residuals, then L2
        # cotangent + replay adjoint; only the band's gradient tables
        # leave the device, psum'd across the mesh
        sq_sum, grads_c = twophase_loss_grads_pallas(
            scene_full, camera, cfg_s, tgt_rows, mask=row_valid,
            denom=denom, interpret=interpret, pts=pts)
        loss = jax.lax.psum(sq_sum, axis) / denom
        grads = grads_to_fitparams(params, scene_full, grads_c)
        grads = jax.lax.psum(grads, axis)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(sharded_step), tgt


def fit(scene: FlatScene, camera: Camera, config: RenderConfig, target,
        steps: int = 200, learning_rate: float = 0.5,
        params: Optional[FitParams] = None,
        optimizer: Optional[optax.GradientTransformation] = None,
        log_every: int = 0) -> Tuple[FitParams, list]:
    """Adam-fit the scene to a target image; returns (params, loss history)."""
    if optimizer is None:
        optimizer = default_fit_optimizer(geom_lr=learning_rate)
    params = FitParams.from_scene(scene) if params is None else params
    opt_state = optimizer.init(params)
    step = make_fit_step(scene, camera, config, target, optimizer)
    history = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state)
        history.append(float(loss))
        if log_every and i % log_every == 0:
            print(f"fit step {i}: loss {float(loss):.6g}")
    return params, history
