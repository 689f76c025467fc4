"""Hand-written backward pass: fixed-topology replay adjoint.

The naive autodiff backward of the bounce chain re-traverses every primitive
sweep, shadow query and argmin (BASELINE's "no naive autodiff through the
bounce loop").  This module implements the custom backward: the Pallas
forward (render_forward_with_residuals) emits tiny per-level residuals —
hit primitive id, resolved material id, per-light lit flag — which pin the
discrete topology (argmin winners, shadow occlusion, checker parity,
branch selection).  Given those ids the radiance is a small closed-form
differentiable function of the scene parameters; ``replay_render``
recomputes it with no intersection sweeps, no argmin and no occlusion
queries, and its autodiff VJP *is* the fixed-hit-topology gradient (the
same topology convention as differentiating the core renderer's
where-selects, at a fraction of the cost).

``render_image_diff`` packages forward+backward as a jax.custom_vjp whose
gradients flow to every float leaf of the scene pytree and the camera.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops.rays import Camera, primary_rays, screen_points
from ..scene.flat import FlatScene, tri_derived
from ..utils.jmath import safe_div, safe_sqrt
from .render_pallas import compact_scene, render_forward_with_residuals


def _sel_rows(onehot, rows):
    """[P,N] one-hot x [N,k] -> [P,k] (gather-free row select)."""
    return jnp.stack([jnp.sum(onehot * rows[None, :, k], axis=1)
                      for k in range(rows.shape[1])], axis=-1)


def _sel_vec(onehot, vec):
    """[P,N] one-hot x [N] -> [P]."""
    return jnp.sum(onehot * vec[None, :], axis=1)


def _node_math(scene: FlatScene, tri_n, tri_nv0, o, v, bik, midl, lits,
               config: RenderConfig):
    """Pinned-topology differentiable math of one bounce node ([P] rays).

    ``bik``/``midl``: this node's hit-primitive / resolved-material ids,
    ``lits``: [L,P] lit flags.  Returns a dict with the local shading color
    (lit/attenuation included, throughput NOT included), the hit point,
    secondary directions, material transparency, and the pinned branch
    flags."""
    nt = scene.num_triangles
    dtype = jnp.float32
    hitm = bik >= 0.0
    prim_ids = jnp.arange(nt + scene.num_spheres, dtype=dtype)
    mat_ids = jnp.arange(scene.num_materials, dtype=dtype)
    onehot = (prim_ids[None, :] == bik[:, None]).astype(dtype)
    oh_tri, oh_sph = onehot[:, :nt], onehot[:, nt:]
    is_tri = bik < nt

    vlen2 = jnp.sum(v * v, -1)
    ray_ok = vlen2 > 0.0
    vlen = safe_sqrt(vlen2, ray_ok)
    u = v * safe_div(jnp.ones_like(vlen), vlen, ray_ok)[:, None]

    # --- hit distance for the known primitive ---
    n_sel = _sel_rows(oh_tri, tri_n)               # [P,3]
    nv0_sel = _sel_vec(oh_tri, tri_nv0)
    ndv = jnp.sum(n_sel * v, -1)
    ndv_ok = jnp.abs(ndv) > 0.0
    m_par = safe_div(nv0_sel - jnp.sum(n_sel * o, -1), ndv, ndv_ok)
    dist_tri = m_par * vlen

    c_sel = _sel_rows(oh_sph, scene.sph_center)
    r_sel = _sel_vec(oh_sph, scene.sph_radius)
    d = c_sel - o
    ud = jnp.sum(u * d, -1)
    disc = ud * ud - jnp.sum(d * d, -1) + r_sel * r_sel
    dist_sph = ud - safe_sqrt(disc, disc > 0.0)

    bd = jnp.where(is_tri, dist_tri, dist_sph)
    bd = jnp.where(hitm, bd, 0.0)
    p = o + bd[:, None] * u

    d0 = p - c_sel
    d0sq = jnp.sum(d0 * d0, -1)
    n_sph = d0 * safe_div(jnp.ones_like(d0sq),
                          safe_sqrt(d0sq, d0sq > 0), d0sq > 0)[:, None]
    n = jnp.where(is_tri[:, None], n_sel, n_sph)
    n = jnp.where(hitm[:, None], n, 0.0)

    # --- material fields via the resolved id ---
    moh = (mat_ids[None, :] == midl[:, None]).astype(dtype)
    amb = _sel_rows(moh, scene.mat_ambient)
    dif = _sel_rows(moh, scene.mat_diffuse)
    spe = _sel_rows(moh, scene.mat_specular)
    trn = _sel_rows(moh, scene.mat_transparency)
    rho = _sel_vec(moh, scene.mat_refraction)
    t_any = (jnp.any(scene.mat_transparency != 0.0, -1)).astype(dtype)
    t_len = jnp.sqrt(jnp.sum(scene.mat_transparency.astype(dtype) ** 2, -1))
    take_flag = jnp.logical_and(t_any > 0.5, t_len > config.small_number
                                ).astype(dtype)
    take_t = _sel_vec(moh, take_flag) > 0.5
    refl_flag = (jnp.any((1.0 - scene.mat_transparency) != 0.0, -1)
                 ).astype(dtype)
    refl_ok = _sel_vec(moh, refl_flag) > 0.5

    # --- secondary directions ---
    cosi = jnp.sum(u * n, -1)
    refl = u - (2.0 * cosi)[:, None] * n
    modulus = 1.0 - rho * rho * (1.0 - cosi * cosi)
    mod_ok = modulus > 0.0
    cosr = safe_sqrt(modulus, mod_ok)
    trans = rho[:, None] * u - (cosr + rho * cosi)[:, None] * n
    trans = jnp.where(mod_ok[:, None], trans, 0.0)

    # --- shading with pinned lit flags (throughput excluded) ---
    local = jnp.zeros_like(p)
    for li in range(scene.num_lights):
        sv = scene.light_pos[li][None, :] - p
        d2 = jnp.sum(sv * sv, -1)
        att = config.attenuation_factor / (config.attenuation_factor + d2)
        inv_sl = safe_div(jnp.ones_like(d2), safe_sqrt(d2, d2 > 0), d2 > 0)
        ndots = jnp.abs(jnp.sum(n * sv, -1)) * inv_sl
        udotr = jnp.abs(jnp.sum(u * refl, -1))
        wgt = jnp.where(jnp.logical_and(lits[li] > 0.5, hitm), att, 0.0)
        contrib = (amb + ndots[:, None] * dif + udotr[:, None] * spe)
        local = local + wgt[:, None] * contrib \
            * scene.light_color[li][None, :]

    return dict(local=local, p=p, refl=refl, trans=trans, trn=trn,
                take_t=take_t, refl_ok=refl_ok, hitm=hitm)


def replay_render(scene: FlatScene, camera: Camera, config: RenderConfig,
                  residuals: Dict[str, Any], pts=None):
    """Differentiable radiance replay of the bounce *chain* -> [H,W,3].

    ``residuals``: bi [D+1,H,W] (hit primitive id in [tris, spheres]
    ordering, -1 = miss), mid [D+1,H,W] (resolved material id, checker
    already applied), lit [L,D+1,H,W] (shadow flags).  Must come from the
    same (compacted) scene the Pallas forward used.  ``pts``: the screen
    points [H*W, 3] the forward used (default: the camera's own; jittered
    samples pass theirs).
    """
    scene = compact_scene(scene)
    w, h = config.width, config.height
    depth = config.max_depth
    dtype = jnp.float32

    der = tri_derived(scene.tri_v0, scene.tri_v1, scene.tri_v2,
                      config.small_number)
    tri_n = der["n"]                                   # [Nt,3]
    tri_nv0 = jnp.sum(tri_n * scene.tri_v0, -1)        # [Nt]

    if pts is None:
        pts = screen_points(camera, w, h)
    o, v = primary_rays(camera, pts)                   # [P,3]
    P = o.shape[0]

    bi = residuals["bi"].reshape(depth + 1, P)
    mid = residuals["mid"].reshape(depth + 1, P)
    lit = residuals["lit"].reshape(scene.num_lights, depth + 1, P)

    color = jnp.zeros((P, 3), dtype)
    thr = jnp.ones((P, 3), dtype)

    for level in range(depth + 1):
        nm = _node_math(scene, tri_n, tri_nv0, o, v, bi[level], mid[level],
                        lit[:, level], config)
        color = color + thr * nm["local"]
        if level < depth:
            take_t, hitm = nm["take_t"], nm["hitm"]
            nxt = jnp.where(take_t[:, None], nm["trans"], nm["refl"])
            weight = jnp.where(take_t[:, None], nm["trn"], 1.0 - nm["trn"])
            thr = thr * jnp.where(hitm[:, None], weight, 1.0)
            o = nm["p"]
            v = jnp.where(hitm[:, None], nxt, 0.0)

    return color.reshape(h, w, 3)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def render_image_diff(scene: FlatScene, camera: Camera, config: RenderConfig,
                      interpret=None):
    """Differentiable Pallas render of a chain-exact scene: forward = the
    kernel, backward = fixed-topology replay VJP.  ``interpret`` as in
    ``render_pallas.use_interpret``."""
    img, _ = render_forward_with_residuals(scene, camera, config,
                                           interpret=interpret)
    return img


def _diff_fwd(scene, camera, config, interpret):
    img, res = render_forward_with_residuals(scene, camera, config,
                                             interpret=interpret)
    return img, (scene, camera, res)


def _diff_bwd(config, interpret, saved, g):
    scene, camera, res = saved
    _, vjp = jax.vjp(
        lambda s, c: replay_render(s, c, config, res), scene, camera)
    return vjp(g)


render_image_diff.defvjp(_diff_fwd, _diff_bwd)


def l2_loss_pallas(params, scene: FlatScene, camera: Camera,
                   config: RenderConfig, target, interpret=None):
    """Drop-in replacement for diff.fit.l2_loss using the Pallas forward and
    the replay adjoint.  Fractional-transparency scenes (the bounce tree)
    take ``diff.fit.l2_loss`` itself."""
    if not scene.chain_exact:
        from ..diff.fit import l2_loss
        return l2_loss(params, scene, camera, config, target)
    img = render_image_diff(params.into_scene(scene), camera, config,
                            interpret)
    return jnp.mean((img - target) ** 2)
