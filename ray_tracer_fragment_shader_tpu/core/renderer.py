"""Pure-JAX reference renderer (the semantics oracle for the Pallas kernels
and the autodiff baseline).

The reference's recursive ``rayTraceRay`` (Hw4/MySdlApplication.cpp:1184-1249)
branches into at most two child rays per hit: a transmitted ray weighted by
the material transparency T and a reflected ray weighted by the opacity 1-T.
Two accelerator-friendly (branchless, batched) realisations:

* ``chain``: an iterative ``lax.scan`` over bounce levels carrying a single
  ray + throughput per pixel.  Exact whenever every material traces at most
  one child (T all-zeros or all-ones — true of all reference materials, see
  Material.chain_exact), because then the bounce *tree* is a bounce *chain*.
* ``tree``: the literal binary recursion, unrolled statically.  Cost
  O(2^depth) traversals; used for parity tests and fractional-T scenes.

Both shade at every level including depth 0, like the reference (shading
happens before the depth>0 recursion gate, ``:1213-1230``).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import CameraConfig, RenderConfig
from ..ops.intersect import intersect_scene
from ..ops.rays import Camera, primary_rays, sample_jitter, screen_points
from ..ops.shading import shade_local
from ..scene.flat import FlatScene
from ..utils.jmath import dot3, norm3, safe_div, safe_sqrt


def _unit(v):
    l2 = dot3(v, v)
    inv = safe_div(jnp.ones_like(l2), safe_sqrt(l2, l2 > 0), l2 > 0)
    return v * inv[:, None]


def _next_branch(hit, small: float):
    """Child-ray selection for the chain renderer: transmitted if the
    reference would trace it (T nonzero and |T| > SMALL, ``:1238``), else
    reflected if opacity is nonzero (``:1243``)."""
    T = hit.transparency
    opacity = 1.0 - T
    t_nonzero = jnp.any(T != 0.0, axis=-1)
    take_trans = jnp.logical_and(t_nonzero, norm3(T) > small)
    refl_ok = jnp.any(opacity != 0.0, axis=-1)
    next_v = jnp.where(take_trans[:, None], hit.trans_dir, hit.refl_dir)
    weight = jnp.where(take_trans[:, None], T, opacity)
    branch_ok = jnp.where(take_trans, dot3(hit.trans_dir, hit.trans_dir) > 0.0,
                          refl_ok)
    return next_v, weight, branch_ok


def render_rays_chain(scene: FlatScene, o, v, *, max_depth: int,
                      small: float, attenuation_factor: float, prune: bool,
                      exclude0=None):
    """Iterative single-path bounce loop; [P,3] color.

    ``exclude0``: optional [P] primitive ids excluded from the *primary*
    intersection (used by the soft-silhouette renderer to compute the
    behind-a-sphere background)."""
    dtype = o.dtype
    # carries derived from the ray inputs so their sharding/varying types
    # match the scan body outputs under shard_map
    color0 = jnp.zeros_like(o)
    thr0 = jnp.zeros_like(o) + 1.0
    alive0 = jnp.zeros_like(o[:, 0]) == 0.0
    if exclude0 is None:
        excl0 = jnp.zeros_like(o[:, 0], dtype=jnp.int32) - 1
    else:
        excl0 = exclude0.astype(jnp.int32)

    def level(carry, _):
        o, v, excl, thr, alive, color = carry
        hit = intersect_scene(scene, o, v, small=small, prune=prune,
                              exclude_id=excl)
        valid = jnp.logical_and(hit.valid, alive)
        local = shade_local(scene, hit, _unit(v), small=small,
                            attenuation_factor=attenuation_factor, prune=prune)
        color = color + thr * local * valid[:, None].astype(dtype)
        next_v, weight, branch_ok = _next_branch(hit, small)
        thr = thr * weight
        alive = valid & branch_ok
        o = hit.point
        return (o, next_v, hit.prim_id, thr, alive, color), None

    (_, _, _, _, _, color), _ = jax.lax.scan(
        level, (o, v, excl0, thr0, alive0, color0), None, length=max_depth + 1)
    return color


def render_rays_tree(scene: FlatScene, o, v, *, max_depth: int,
                     small: float, attenuation_factor: float, prune: bool):
    """Full binary bounce tree (transmitted + reflected children at every
    hit), the literal ``rayTraceRay`` semantics.  Statically unrolled."""
    dtype = o.dtype

    def trace(o, v, depth, excl=None):
        hit = intersect_scene(scene, o, v, small=small, prune=prune,
                              exclude_id=excl)
        local = shade_local(scene, hit, _unit(v), small=small,
                            attenuation_factor=attenuation_factor, prune=prune)
        color = local
        if depth > 0:
            T = hit.transparency
            opacity = 1.0 - T
            take_trans = jnp.logical_and(jnp.any(T != 0.0, -1),
                                         norm3(T) > small)
            refl_ok = jnp.any(opacity != 0.0, -1)
            # Child rays of misses/dead branches have zero direction and
            # contribute nothing; the masks make that explicit.
            ct = trace(hit.point,
                       jnp.where(take_trans[:, None], hit.trans_dir, 0.0),
                       depth - 1, excl=hit.prim_id)
            cr = trace(hit.point,
                       jnp.where(refl_ok[:, None], hit.refl_dir, 0.0),
                       depth - 1, excl=hit.prim_id)
            color = color + jnp.where(take_trans[:, None], T * ct, 0.0)
            color = color + jnp.where(refl_ok[:, None], opacity * cr, 0.0)
        return jnp.where(hit.valid[:, None], color, jnp.zeros_like(color))

    return trace(o, v, max_depth).astype(dtype)


def render_rays(scene: FlatScene, o, v, *, max_depth: int, mode: str = "auto",
                small: float = 1e-4, attenuation_factor: float = 1e5,
                prune: bool = True):
    resolved = mode if mode != "auto" else ("chain" if scene.chain_exact else "tree")
    fn = render_rays_chain if resolved == "chain" else render_rays_tree
    return fn(scene, o, v, max_depth=max_depth, small=small,
              attenuation_factor=attenuation_factor, prune=prune)


def _chunked(fn, o, v, chunk_size: int):
    """Apply fn over [P,...] rays in fixed-size chunks via lax.map to bound
    the peak [rays, primitives] working set."""
    P = o.shape[0]
    if P <= chunk_size:
        return fn(o, v)
    pad = (-P) % chunk_size
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)], 0)
        v = jnp.concatenate([v, jnp.zeros((pad, 3), v.dtype)], 0)
    n = o.shape[0] // chunk_size
    o = o.reshape(n, chunk_size, 3)
    v = v.reshape(n, chunk_size, 3)
    out = jax.lax.map(lambda ab: fn(ab[0], ab[1]), (o, v))
    out = out.reshape(n * chunk_size, -1)
    return out[:P]


def render_pixels(scene: FlatScene, camera: Camera, width: int, height: int,
                  config: RenderConfig, ij=None, key=None):
    """Render a flat pixel set (all pixels when ij is None) -> [P,3].

    Supersampling averages ``config.samples`` jittered renders; with one
    sample and no ``force_jitter`` the ray goes through the exact screen
    point (the reference's jitter exists only for its supersampler,
    MySdlApplication.cpp:1294-1311)."""
    return render_points(scene, camera, screen_points(camera, width, height,
                                                      ij=ij), config, key)


def render_points(scene: FlatScene, camera: Camera, pts, config: RenderConfig,
                  key=None):
    """Render through given screen points [P,3] -> [P,3] (``render_pixels``
    after its screen-point step)."""
    P = pts.shape[0]
    mode = config.resolved_mode(scene.chain_exact)
    trace = functools.partial(
        render_rays, scene, max_depth=config.max_depth, mode=mode,
        small=config.small_number,
        attenuation_factor=config.attenuation_factor, prune=config.prune)
    traced = lambda o, v: _chunked(trace, o, v, config.chunk_size)

    use_jitter = config.samples > 1 or config.force_jitter
    if not use_jitter:
        o, v = primary_rays(camera, pts)
        return traced(o, v)

    if key is None:
        key = jax.random.PRNGKey(config.seed)
    keys = jax.random.split(key, config.samples)

    if not config.adaptive:
        def one_sample(carry, k):
            jit = sample_jitter(k, P, config.jitter_scale, dtype=pts.dtype)
            o, v = primary_rays(camera, pts, jitter=jit)
            return carry + traced(o, v), None

        total, _ = jax.lax.scan(one_sample, jnp.zeros_like(pts), keys)
        return total / config.samples

    # Adaptive supersampler emulation (MySdlApplication.cpp:1294-1311):
    # sample k joins the sum while the pixel is unconverged; convergence
    # tests |k*avg_after - (k+1)*avg_before| < SMALL*k*(k+1); the divisor is
    # the loop variable at exit (the reference divides the k+1 accumulated
    # samples by k when it breaks early).  All samples are computed (SPMD);
    # convergence only masks accumulation.
    small = config.small_number

    def adaptive_sample(carry, inp):
        accum, divisor, done = carry
        k, key_k = inp
        jit = sample_jitter(key_k, P, config.jitter_scale, dtype=pts.dtype)
        o, v = primary_rays(camera, pts, jitter=jit)
        c = traced(o, v)
        accum_after = jnp.where(done[:, None], accum, accum + c)
        diff = norm3(k * accum_after - (k + 1.0) * accum)
        newly_done = jnp.logical_and(~done, diff < small * k * (k + 1.0))
        divisor = jnp.where(newly_done, k, divisor)
        done = jnp.logical_or(done, newly_done)
        return (accum_after, divisor, done), None

    ks = jnp.arange(config.samples, dtype=pts.dtype)
    init = (jnp.zeros_like(pts), jnp.full((P,), float(config.samples),
                                          pts.dtype),
            jnp.zeros((P,), bool))
    (accum, divisor, _), _ = jax.lax.scan(adaptive_sample, init, (ks, keys))
    return accum / divisor[:, None]


def render_image(scene: FlatScene, camera, config: RenderConfig,
                 key=None):
    """Full-frame render -> [H,W,3], row j=0 = bottom scanline (GL screen
    coordinates, like the reference's gluOrtho2D window)."""
    if isinstance(camera, CameraConfig):
        camera = Camera.from_config(camera, config.width, config.height)
    flat = render_pixels(scene, camera, config.width, config.height, config,
                         key=key)
    return flat.reshape(config.height, config.width, 3)


@functools.partial(jax.jit, static_argnames=("config",))
def render_image_jit(scene: FlatScene, camera: Camera, config: RenderConfig):
    return render_image(scene, camera, config)
