"""Batched, branchless closest-hit over the flattened scene.

This is the data-parallel re-design of the reference's virtual-dispatch composite
traversal (``Shape::intersection`` / ``Triangle::intersection``,
Hw4/MySdlApplication.cpp:611-823): every ray is tested against *all*
primitives with masked vector math, then a single argmin picks the nearest
hit — no data-dependent control flow, everything is fused elementwise
work and small reductions.

The ray-primitive inner products are [P,3]x[3,N] contractions written as
three broadcast FMAs (``_matdot``), not matrix products.

Semantic parity notes (each mirrors a specific reference behaviour):
  * sphere hit iff ``disc >= 0 && s >= eps`` with ``s`` the *near* root only
    (``:747-771``) — rays starting inside a sphere never hit it;
  * triangle epsilons applied to the raw (unnormalized) ray parameter ``m``
    (``:651-663``);
  * nearest hit by Euclidean distance from the ray origin with strict ``<``
    (``:811-815``), so ties keep the earliest primitive (triangles are
    ordered before spheres, matching reference scene insertion order);
  * hierarchical bounding-sphere pruning with the reference's exact
    rejection test ``disc < 0 || |s| < eps`` (``:749-758``), optional;
  * the checkerboard's procedural material override by square parity with
    C-style truncation (``CheckerBoard::intersection``, ``:1084-1113``);
  * reflected/transmitted directions computed from the *geometric* normal,
    never flipped toward the ray (``:677-699``).
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..scene.flat import FlatScene, tri_derived
from ..utils.jmath import dot3, norm3, safe_div, safe_sqrt
from ..utils.pytree import pytree_dataclass

# plain Python float (a module-level jnp constant would initialize the JAX
# backend at import time, defeating later platform selection e.g. --cpu)
BIG = 3.0e38


@pytree_dataclass
class Hit:
    valid: Any         # [P] bool — any primitive hit
    prim_id: Any       # [P] i32 — index of the hit primitive in the unified
    #                    [triangles, spheres] ordering (-1 when no hit); pass
    #                    back as ``exclude_id`` for secondary rays
    dist: Any          # [P] Euclidean distance origin->hit (BIG if none)
    point: Any         # [P,3] hit point (== origin when no hit)
    normal: Any        # [P,3] geometric unit normal (unflipped)
    refl_dir: Any      # [P,3] unit reflected direction
    trans_dir: Any     # [P,3] transmitted direction (zero on TIR / no hit)
    ambient: Any       # [P,3] material of the hit (checker-resolved)
    diffuse: Any       # [P,3]
    specular: Any      # [P,3]
    transparency: Any  # [P,3]
    refraction: Any    # [P]


def _matdot(a, b_t):
    """[P,3] x [N,3] -> [P,N] inner products as three fused broadcast FMAs.

    Deliberately NOT a matmul: a K=3 contraction wastes a matrix unit, and
    a reduced default matmul precision (TF32 on a GPU) keeps only ~3
    decimal digits, which destroys the ray-geometry cancellations (hit
    points land ~1 world unit off the surface -> catastrophic shadow
    acne).  The FMA form is exact f32 and fuses."""
    return (a[:, 0, None] * b_t[None, :, 0]
            + a[:, 1, None] * b_t[None, :, 1]
            + a[:, 2, None] * b_t[None, :, 2])


def _onehot_rows(onehot, rows):
    """[P,N] one-hot x [N,3] table -> [P,3] selected rows, as three masked
    reductions (gather- and matmul-free)."""
    return jnp.stack([jnp.sum(onehot * rows[None, :, k], axis=1)
                      for k in range(rows.shape[1])], axis=-1)


def _expand_groups(values, group_onehot):
    """[P,G] per-group values -> [P,N] per-primitive values via the static
    [G,N] membership one-hot, unrolled over the (small) group axis."""
    G = group_onehot.shape[0]
    out = values[:, 0, None] * group_onehot[0][None, :]
    for g in range(1, G):
        out = out + values[:, g, None] * group_onehot[g][None, :]
    return out


def group_prune_mask(scene: FlatScene, o, u, small: float):
    """[P,G] True where the reference's bounding-sphere test rejects the ray
    for that group (Shape::intersection, MySdlApplication.cpp:747-758):
    reject iff ``disc < 0 || |s| < SMALL_NUMBER`` using the *normalized*
    direction.  Groups with radius <= 0 never prune."""
    gc, gr = scene.grp_center, scene.grp_radius
    u_dot_c = _matdot(u, gc)
    o_dot_c = _matdot(o, gc)
    u_delta = u_dot_c - dot3(u, o)[:, None]
    dd = dot3(gc, gc)[None, :] - 2.0 * o_dot_c + dot3(o, o)[:, None]
    disc = u_delta * u_delta - dd + (gr * gr)[None, :]
    # strict >0 in the sqrt mask: at disc==0 the value is identical (sqrt=0)
    # but the masked branch avoids an inf sqrt-gradient (inf*0 = NaN).
    s = u_delta - safe_sqrt(disc, disc > 0)
    rejected = jnp.logical_or(disc < 0.0, jnp.abs(s) < small)
    return jnp.logical_and(rejected, (gr > 0.0)[None, :])


def intersect_scene(scene: FlatScene, o, v, *, small: float = 1e-4,
                    prune: bool = True, exclude_id=None) -> Hit:
    """Closest hit of rays (o, v) against the whole scene.

    o, v: [P,3]; v is the raw (unnormalized) direction, reference ``Line``
    convention (endpoint - startpoint).

    ``exclude_id`` ([P] i32, -1 for none) removes one primitive per ray from
    consideration — used for secondary rays originating *on* a primitive.
    In exact arithmetic this is equivalent to the reference's rejection of
    such hits (sphere near-root ``s == 0``/negative from its own surface,
    MySdlApplication.cpp:752-767; triangle plane parameter ``m ~ 0 < eps``,
    ``:657-659``; planar/convex primitives can never legitimately re-hit
    themselves), but unlike an epsilon test it stays robust in float32,
    where hit points land ~1e-3 world units off the surface.
    """
    dtype = o.dtype
    P = o.shape[0]
    nt = scene.num_triangles
    ns = scene.num_spheres

    vlen2 = dot3(v, v)
    ray_ok = vlen2 > 0.0
    vlen = safe_sqrt(vlen2, ray_ok)
    inv_vlen = safe_div(jnp.ones_like(vlen), vlen, ray_ok)
    u = v * inv_vlen[:, None]

    if prune:
        pruned = group_prune_mask(scene, o, u, small)  # [P,G]
        # group -> primitive expansion as a [P,G] x [G,N] one-hot
        # reduction (see the one-hot note below)
        gids = jnp.arange(scene.num_groups, dtype=jnp.int32)
        tri_g = (gids[:, None] == scene.tri_group[None, :]).astype(dtype)
        sph_g = (gids[:, None] == scene.sph_group[None, :]).astype(dtype)
        pruned_f = pruned.astype(dtype)
        tri_pruned = _expand_groups(pruned_f, tri_g) > 0.5
        sph_pruned = _expand_groups(pruned_f, sph_g) > 0.5
    else:
        tri_pruned = jnp.zeros((P, nt), bool)
        sph_pruned = jnp.zeros((P, ns), bool)

    # --- spheres: disc = (u.dP)^2 - dP.dP + r^2, near root s = u.dP - sqrt
    c, r = scene.sph_center, scene.sph_radius
    u_dot_c = _matdot(u, c)
    o_dot_c = _matdot(o, c)
    u_delta = u_dot_c - dot3(u, o)[:, None]
    dd = dot3(c, c)[None, :] - 2.0 * o_dot_c + dot3(o, o)[:, None]
    disc = u_delta * u_delta - dd + (r * r)[None, :]
    disc_ok = disc >= 0.0
    # sqrt masked on strict >0: same values (sqrt(0)=0) but no inf gradient
    # when a dead secondary ray originates exactly on a sphere (disc==0).
    s_sph = u_delta - safe_sqrt(disc, disc > 0.0)
    sph_hit = (disc_ok & (s_sph >= small) & scene.sph_valid[None, :]
               & ray_ok[:, None] & ~sph_pruned)
    sph_dist = jnp.where(sph_hit, s_sph, BIG)

    # --- triangles: plane parameter m on the raw ray, then barycentric s,t
    der = tri_derived(scene.tri_v0, scene.tri_v1, scene.tri_v2, small)
    n, ue, ve = der["n"], der["u"], der["v"]
    n_dot_v = _matdot(v, n)
    n_dot_o = _matdot(o, n)
    n_dot_v0 = dot3(n, scene.tri_v0)
    plane_ok = jnp.abs(n_dot_v) >= small
    m = safe_div(n_dot_v0[None, :] - n_dot_o, n_dot_v, plane_ok)
    m_ok = m >= small
    o_u = _matdot(o, ue); v_u = _matdot(v, ue)
    o_v = _matdot(o, ve); v_v = _matdot(v, ve)
    wu = o_u + m * v_u - dot3(scene.tri_v0, ue)[None, :]
    wv = o_v + m * v_v - dot3(scene.tri_v0, ve)[None, :]
    inv_den = 1.0 / der["denominator"]  # degenerate tris are masked out
    inv_den = jnp.where(der["degenerate"], 0.0, inv_den)[None, :]
    sb = (der["uv"][None, :] * wv - der["vv"][None, :] * wu) * inv_den
    tb = (der["uv"][None, :] * wu - der["uu"][None, :] * wv) * inv_den
    inside = (sb >= 0.0) & (tb >= 0.0) & (sb + tb <= 1.0)
    tri_hit = (plane_ok & m_ok & inside & ~der["degenerate"][None, :]
               & scene.tri_valid[None, :] & ray_ok[:, None] & ~tri_pruned)
    tri_dist = jnp.where(tri_hit, m * vlen[:, None], BIG)

    # --- nearest across [triangles, spheres] (ties keep earliest, matching
    # the reference's strict-< nearest test and insertion order)
    all_dist = jnp.concatenate([tri_dist, sph_dist], axis=1)
    if exclude_id is not None:
        col = jax.lax.broadcasted_iota(jnp.int32, all_dist.shape, 1)
        all_dist = jnp.where(col == exclude_id[:, None], BIG, all_dist)
    best = jnp.argmin(all_dist, axis=1)
    # Everything below is phrased as one-hot reductions instead of per-ray
    # gathers (take_along_axis / fancy indexing) — a choice made for an
    # earlier accelerator; gathers may well be cheaper on a GPU (ROADMAP).
    col = jax.lax.broadcasted_iota(jnp.int32, all_dist.shape, 1)
    onehot_b = col == best[:, None]              # [P, nt+ns] bool
    onehot = onehot_b.astype(dtype)
    oh_tri, oh_sph = onehot[:, :nt], onehot[:, nt:]
    best_dist = jnp.sum(all_dist * onehot, axis=1)
    valid = best_dist < BIG
    is_tri = best < nt

    # --- recover per-ray hit attributes for the winning primitive
    m_best = jnp.sum(m * oh_tri, axis=1)
    point_tri = o + m_best[:, None] * v
    n_tri = _onehot_rows(oh_tri, n)              # [P,3] one-hot select

    s_best = jnp.sum(s_sph * oh_sph, axis=1)
    point_sph = o + s_best[:, None] * u
    d0 = point_sph - _onehot_rows(oh_sph, c)
    d0_len = norm3(d0)
    n_sph = d0 * safe_div(jnp.ones_like(d0_len), d0_len, d0_len > 0)[:, None]

    point = jnp.where(is_tri[:, None], point_tri, point_sph)
    point = jnp.where(valid[:, None], point, o)
    normal = jnp.where(is_tri[:, None], n_tri, n_sph)
    normal = jnp.where(valid[:, None], normal, jnp.zeros_like(normal))

    # --- per-primitive material rows (tiny static-size gathers from the
    # material table, no [P]-indexed gathers), selected by the hit one-hot
    prim_amb = jnp.concatenate([scene.mat_ambient[scene.tri_mat],
                                scene.mat_ambient[scene.sph_mat]], 0)
    prim_dif = jnp.concatenate([scene.mat_diffuse[scene.tri_mat],
                                scene.mat_diffuse[scene.sph_mat]], 0)
    prim_spe = jnp.concatenate([scene.mat_specular[scene.tri_mat],
                                scene.mat_specular[scene.sph_mat]], 0)
    prim_trn = jnp.concatenate([scene.mat_transparency[scene.tri_mat],
                                scene.mat_transparency[scene.sph_mat]], 0)
    prim_rho = jnp.concatenate([scene.mat_refraction[scene.tri_mat],
                                scene.mat_refraction[scene.sph_mat]], 0)
    prim_chk = jnp.concatenate([scene.tri_checker,
                                jnp.zeros((ns,), bool)], 0).astype(dtype)

    ambient = _onehot_rows(onehot, prim_amb)
    diffuse = _onehot_rows(onehot, prim_dif)
    specular = _onehot_rows(onehot, prim_spe)
    transparency = _onehot_rows(onehot, prim_trn)
    refraction = jnp.sum(onehot * prim_rho[None, :], axis=1)
    refraction = jnp.where(valid, refraction, 1.0)

    # --- checkerboard procedural override (CheckerBoard::intersection):
    # square parity of the board-local hit point with C-style int()
    # truncation; the two square materials are static rows (checker_mats)
    # so the override is a pure where-select, gather-free.
    is_checker = (jnp.sum(onehot * prim_chk[None, :], axis=1) > 0.5) & valid
    prel = point - scene.board_pos[None, :]
    px = prel[:, 0] + scene.board_half
    pz = prel[:, 2] + scene.board_half
    sq_sum = (jnp.trunc(px / scene.board_square).astype(jnp.int32)
              + jnp.trunc(pz / scene.board_square).astype(jnp.int32))
    white_id, black_id = scene.checker_mats
    even = (sq_sum % 2 == 0)
    def _chk(table):
        sel = jnp.where(even[:, None], table[white_id][None, :],
                        table[black_id][None, :])
        return jnp.where(is_checker[:, None], sel, 0.0)
    ambient = jnp.where(is_checker[:, None], 0.0, ambient) + _chk(scene.mat_ambient)
    diffuse = jnp.where(is_checker[:, None], 0.0, diffuse) + _chk(scene.mat_diffuse)
    specular = jnp.where(is_checker[:, None], 0.0, specular) + _chk(scene.mat_specular)
    transparency = (jnp.where(is_checker[:, None], 0.0, transparency)
                    + _chk(scene.mat_transparency))
    rho_chk = jnp.where(even, scene.mat_refraction[white_id],
                        scene.mat_refraction[black_id])
    refraction = jnp.where(is_checker, rho_chk, refraction)

    # --- secondary directions from the unit incoming direction and the
    # geometric (unflipped) normal: r = u - 2(u.n)n; Snell/thin-lens t with
    # TIR -> zero vector (a zero ray then misses everything, reproducing the
    # reference's dead transmitted ray; see SEMANTICS.md on the NaN quirk).
    cosi = dot3(u, normal)
    refl_dir = u - (2.0 * cosi)[:, None] * normal
    rho = refraction
    modulus = 1.0 - rho * rho * (1.0 - cosi * cosi)
    mod_ok = modulus > 0.0
    cosr = safe_sqrt(modulus, mod_ok)
    trans_dir = rho[:, None] * u - (cosr + rho * cosi)[:, None] * normal
    trans_dir = jnp.where((mod_ok & valid)[:, None], trans_dir,
                          jnp.zeros_like(trans_dir))
    refl_dir = jnp.where(valid[:, None], refl_dir, jnp.zeros_like(refl_dir))

    zero3 = jnp.zeros((P, 3), dtype)
    mask3 = valid[:, None]
    return Hit(
        valid=valid,
        prim_id=jnp.where(valid, best.astype(jnp.int32), -1),
        dist=jnp.where(valid, best_dist, BIG),
        point=point,
        normal=normal,
        refl_dir=refl_dir,
        trans_dir=trans_dir,
        ambient=jnp.where(mask3, ambient, zero3),
        diffuse=jnp.where(mask3, diffuse, zero3),
        specular=jnp.where(mask3, specular, zero3),
        transparency=jnp.where(mask3, transparency, zero3),
        refraction=jnp.where(valid, refraction, jnp.ones_like(refraction)),
    )
