"""Fully in-kernel backward pass: the replay adjoint as Pallas kernels
(Triton route).

``kernels/adjoint.py`` pins the discrete hit topology with per-level residuals
and re-derives the radiance as a small differentiable function — but it runs
that replay (and its VJP) as an XLA program over the whole image, which
materializes [P, N] one-hot selection masks in device memory.  Here each
program replays the bounce chain for one block of pixels in registers and
differentiates it on the spot with a HAND-WRITTEN adjoint (a lean primal
sweep plus an explicit reverse sweep — no ``jax.vjp``; every sqrt/divide
adjoint reuses a primal reciprocal and the colour accumulation is skipped).
Each program writes its own partial sums of the parameter gradients (and of
the loss) into its own row of a small table; XLA sums the rows after the
call, so the reduction is deterministic and needs no atomics.  No [P, N]
buffer ever exists; device-memory traffic is the residuals and cotangent.

Two kernels, one backward per kind of chain fit:
  * the packed two-phase backward (single-sample fits): phase 1 is the
    forward kernel emitting one packed residual plane per bounce level
    (``render_pallas.render_forward``), phase 2 forms the L2 cotangent and
    loss in its prologue and runs the adjoint;
  * the recompute backward (supersampled and adaptive fits): the forward
    chain is re-traced into registers inside the backward kernel, with the
    cotangent supplied from outside, one launch per sample.

Scope: gradients w.r.t. the differentiable-fit parameter set (``FitParams``:
sphere centers/radii, light positions, material ambient/diffuse/specular) —
the BASELINE config-4 workload.  For gradients w.r.t. other leaves (camera,
triangle vertices) use the XLA replay (``kernels/adjoint.py``).
Fractional-transparency scenes (the bounce tree) differentiate through the
XLA tree renderer (``diff.fit.l2_loss``).

Like the replay, gradients are defined through fixed hit topology
(SURVEY.md §7 "Hard parts": hit/miss, checker parity and shadow edges carry
no gradient) — the convention the reference's semantics imply for its
branch-heavy shading (Hw4/MySdlApplication.cpp:1184-1249).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from ..config import RenderConfig
from ..diff.fit import FitParams, l2_loss
from ..ops.rays import Camera, sample_jitter, screen_points
from ..scene.flat import FlatScene
from . import render_pallas
from .render_pallas import (PLANE_MULT, _chain_forward, _make_tile_ops,
                            _sweep_loop, compact_scene, kernel_statics,
                            pack_scene_for, pack_widths, pad_plane,
                            plane_spec, ray_planes, render_forward, tables,
                            triton_call, unpack_level, use_interpret, whole)

def grad_layout(ns: int, m: int, nl: int):
    """Layout of one program's partial sums: ``[loss, sphere (cx cy cz r)
    x ns, material (amb3 dif3 spe3) x m, light (pos3) x nl]``, padded to a
    power of two (Triton stores power-of-two blocks).  Returns (number of
    used slots, padded width)."""
    used = 1 + 4 * ns + 9 * m + 3 * nl
    width = 1
    while width < used:
        width *= 2
    return used, width


def _partials_row(sums, width: int):
    """Scalar partial sums -> one [width] row (zeros past the used slots)."""
    idx = jax.lax.broadcasted_iota(jnp.int32, (width,), 0)
    row = jnp.zeros((width,), jnp.float32)
    for f, s in enumerate(sums):
        row = jnp.where(idx == f, s, row)
    return row


def reduce_partials(partials, ns_k: int, m: int, nl: int, ns: int):
    """Sum the programs' partial rows [G, width] and split the result into
    (loss sum, compacted-scene gradient tables).  ``ns_k`` is the kernel's
    sphere row count (at least 1), ``ns`` the scene's."""
    tot = jnp.sum(partials, 0)
    o = 1
    sph = tot[o:o + 4 * ns_k].reshape(ns_k, 4)
    o += 4 * ns_k
    mat = tot[o:o + 9 * m].reshape(m, 9)
    o += 9 * m
    light = tot[o:o + 3 * nl].reshape(nl, 3)
    return tot[0], dict(sph_center=sph[:ns, 0:3], sph_radius=sph[:ns, 3],
                        mat_ambient=mat[:, 0:3], mat_diffuse=mat[:, 3:6],
                        mat_specular=mat[:, 6:9], light_pos=light)


def _node_reverse(c, rec, gath_n, d_gath_n, d_lp, lcol, G3, atten, nl,
                  inflow):
    """Reverse sweep of ONE bounce node of the chain adjoint.
    ``c``/``rec``: the node's constants and
    primal record; ``gath_n``/``d_gath_n``: its 13 pre-gathered parameter
    planes and their cotangent accumulators (mutated in place, like
    ``d_lp``); ``G3``: the per-channel cotangent scale of this node's local
    shading (throughput x image cotangent); ``inflow``: dict of cotangents
    arriving from the node's child — p (3), r (3), u (3), n (3), cosi —
    zeros where absent.
    Returns (o_b 3-tuple, v_b 3-tuple), the cotangents of the node's input
    ray.  Every masked select transposes to a masked cotangent; each
    guarded sqrt/div adjoint reuses the primal's reciprocal (self-masking:
    the stored inverses are already zero on dead lanes)."""
    hitm, is_tri = c["hitm"], c["is_tri"]
    ux, uy, uz = rec["ux"], rec["uy"], rec["uz"]
    nx, ny, nz = rec["nx"], rec["ny"], rec["nz"]
    rx, ry, rz = rec["rx"], rec["ry"], rec["rz"]
    cosi = rec["cosi"]

    p_bx, p_by, p_bz = inflow["p"]
    u_bx, u_by, u_bz = inflow["u"]
    n_bx, n_by, n_bz = inflow["n"]
    r_bx, r_by, r_bz = inflow["r"]
    cosi_b = inflow["cosi"]

    # shading: col_ch += G3_ch * wgt * (amb + ndots*dif + udotr*spe)
    #          * lcol_ch, per light
    gr_, gg_, gb_ = G3
    amb = gath_n[4:7]
    dif = gath_n[7:10]
    spe = gath_n[10:13]
    for li in range(nl):
        svx, svy, svz, att, inv_sl, dot_ns, dot_ur = rec["lights"][li]
        lr, lg, lb = lcol[li]
        mask_w = jnp.logical_and(c["lits"][li], hitm)
        wgt = jnp.where(mask_w, att, 0.0)
        abs_ns = jnp.abs(dot_ns)
        ndots = abs_ns * inv_sl
        udotr = jnp.abs(dot_ur)
        kr = wgt * (lr * gr_)
        kg = wgt * (lg * gg_)
        kb = wgt * (lb * gb_)
        d_gath_n[4] += kr
        d_gath_n[5] += kg
        d_gath_n[6] += kb
        d_gath_n[7] += kr * ndots
        d_gath_n[8] += kg * ndots
        d_gath_n[9] += kb * ndots
        d_gath_n[10] += kr * udotr
        d_gath_n[11] += kg * udotr
        d_gath_n[12] += kb * udotr
        ndots_b = kr * dif[0] + kg * dif[1] + kb * dif[2]
        udotr_b = kr * spe[0] + kg * spe[1] + kb * spe[2]
        s_r = amb[0] + ndots * dif[0] + udotr * spe[0]
        s_g = amb[1] + ndots * dif[1] + udotr * spe[1]
        s_b = amb[2] + ndots * dif[2] + udotr * spe[2]
        wgt_b = (gr_ * lr * s_r + gg_ * lg * s_g + gb_ * lb * s_b)
        att_b = jnp.where(mask_w, wgt_b, 0.0)
        # att = A/(A+d2): d att/d d2 = -att^2/A
        d2_b = att_b * att * att * (-1.0 / atten)
        # udotr = |u.r|
        dur_b = udotr_b * jnp.sign(dot_ur)
        u_bx += dur_b * rx
        u_by += dur_b * ry
        u_bz += dur_b * rz
        r_bx += dur_b * ux
        r_by += dur_b * uy
        r_bz += dur_b * uz
        # ndots = |n.sv| * inv_sl; inv_sl = where(ok, d2^-1/2, 0)
        dns_b = ndots_b * inv_sl * jnp.sign(dot_ns)
        d2_b += ndots_b * abs_ns * (-0.5) * inv_sl * inv_sl * inv_sl
        n_bx += dns_b * svx
        n_by += dns_b * svy
        n_bz += dns_b * svz
        sv_bx = dns_b * nx + 2.0 * d2_b * svx
        sv_by = dns_b * ny + 2.0 * d2_b * svy
        sv_bz = dns_b * nz + 2.0 * d2_b * svz
        # sv = lp - p
        d_lp[li][0] += sv_bx
        d_lp[li][1] += sv_by
        d_lp[li][2] += sv_bz
        p_bx -= sv_bx
        p_by -= sv_by
        p_bz -= sv_bz

    # r = u - 2 cosi n
    u_bx += r_bx
    u_by += r_by
    u_bz += r_bz
    cosi_b -= 2.0 * (r_bx * nx + r_by * ny + r_bz * nz)
    two_cosi = 2.0 * cosi
    n_bx -= two_cosi * r_bx
    n_by -= two_cosi * r_by
    n_bz -= two_cosi * r_bz
    # cosi = u.n
    u_bx += cosi_b * nx
    u_by += cosi_b * ny
    u_bz += cosi_b * nz
    n_bx += cosi_b * ux
    n_by += cosi_b * uy
    n_bz += cosi_b * uz

    # n = where(hitm, where(is_tri, tn, d0 * inv_d0), 0)
    m_sphn = jnp.logical_and(hitm, jnp.logical_not(is_tri))
    ns_bx = jnp.where(m_sphn, n_bx, 0.0)
    ns_by = jnp.where(m_sphn, n_by, 0.0)
    ns_bz = jnp.where(m_sphn, n_bz, 0.0)
    inv_d0 = rec["inv_d0"]
    d0x, d0y, d0z = rec["d0x"], rec["d0y"], rec["d0z"]
    invd0_b = ns_bx * d0x + ns_by * d0y + ns_bz * d0z
    # inv_d0 = where(ok, d0sq^-1/2, 0): d/d d0sq = -inv_d0^3/2 (self-masked)
    d0sq_b = (-0.5) * inv_d0 * inv_d0 * inv_d0 * invd0_b
    two_d0sq_b = 2.0 * d0sq_b
    d0_bx = inv_d0 * ns_bx + two_d0sq_b * d0x
    d0_by = inv_d0 * ns_by + two_d0sq_b * d0y
    d0_bz = inv_d0 * ns_bz + two_d0sq_b * d0z
    # d0 = p - c
    p_bx += d0_bx
    p_by += d0_by
    p_bz += d0_bz
    c_bx = -d0_bx
    c_by = -d0_by
    c_bz = -d0_bz

    # p = o + bd * u
    o_bx, o_by, o_bz = p_bx, p_by, p_bz
    bd_b = p_bx * ux + p_by * uy + p_bz * uz
    bd = rec["bd"]
    u_bx += bd * p_bx
    u_by += bd * p_by
    u_bz += bd * p_bz

    # bd = where(hitm, where(is_tri, dist_tri, dist_sph), 0)
    dt_b = jnp.where(jnp.logical_and(hitm, is_tri), bd_b, 0.0)
    ds_b = jnp.where(m_sphn, bd_b, 0.0)

    # dist_sph = ud - safe_sqrt(disc); disc = ud^2 - d.d + rr^2; ud = u.d
    disc_b = jnp.where(rec["disc_ok"],
                       (-0.5) * rec["inv_sq"] * ds_b, 0.0)
    ud_b = ds_b + 2.0 * rec["ud"] * disc_b
    dx, dy, dz = rec["dx"], rec["dy"], rec["dz"]
    rr = gath_n[3]
    d_gath_n[3] += 2.0 * rr * disc_b
    neg2disc_b = -2.0 * disc_b
    d_bx = neg2disc_b * dx + ud_b * ux
    d_by = neg2disc_b * dy + ud_b * uy
    d_bz = neg2disc_b * dz + ud_b * uz
    u_bx += ud_b * dx
    u_by += ud_b * dy
    u_bz += ud_b * dz
    # d = c - o
    c_bx += d_bx
    c_by += d_by
    c_bz += d_bz
    o_bx -= d_bx
    o_by -= d_by
    o_bz -= d_bz
    d_gath_n[0] += c_bx
    d_gath_n[1] += c_by
    d_gath_n[2] += c_bz

    # dist_tri = m_par * vlen; m_par = safe_div(tnv0 - tn.o, ndv);
    # ndv = tn.v; ndo = tn.o
    tnx, tny, tnz = c["tn"]
    m_b = dt_b * rec["vlen"]
    vlen_b = dt_b * rec["m_par"]
    inv_ndv = rec["inv_ndv"]
    ndo_b = jnp.where(rec["ndv_ok"], -m_b * inv_ndv, 0.0)
    ndv_b = -rec["m_par"] * inv_ndv * m_b   # m_par self-masks dead lanes
    o_bx += ndo_b * tnx
    o_by += ndo_b * tny
    o_bz += ndo_b * tnz
    v_bx = ndv_b * tnx
    v_by = ndv_b * tny
    v_bz = ndv_b * tnz

    # u = v * ivl; ivl = where(ok, vlen2^-1/2, 0); vlen = vlen2 * ivl
    ivl = rec["ivl"]
    vx_, vy_, vz_ = rec["vx"], rec["vy"], rec["vz"]
    v_bx += u_bx * ivl
    v_by += u_by * ivl
    v_bz += u_bz * ivl
    ivl_b = u_bx * vx_ + u_by * vy_ + u_bz * vz_
    vlen_b -= ivl * ivl * ivl_b             # d(1/vlen)/dvlen, self-masked
    vlen2_b = 0.5 * vlen_b * ivl            # d sqrt/d vlen2, self-masked
    two_vlen2_b = 2.0 * vlen2_b
    v_bx += two_vlen2_b * vx_
    v_by += two_vlen2_b * vy_
    v_bz += two_vlen2_b * vz_

    return (o_bx, o_by, o_bz), (v_bx, v_by, v_bz)


def _masked_rsqrt(x, ok):
    """(where(ok, 1/sqrt(x), 0), where(ok, sqrt(x), 0)) from ONE rsqrt:
    sqrt(x) = x * rsqrt(x).  Matches safe_sqrt / safe_div(1, ., ok)
    values exactly (1-ulp)."""
    x_safe = jnp.where(ok, x, 1.0)
    inv = jnp.where(ok, jax.lax.rsqrt(x_safe), 0.0)
    return inv, x * inv


def _node_primal(c, gath_n, lp, o, v, *, nl: int, atten: float,
                 want_snell: bool):
    """Hand-written primal sweep of ONE bounce node — the forward half
    of the chain replay adjoint.  Mirrors
    kernels/adjoint.py::_node_math value-for-value (same guards, 1-ulp
    rsqrt-vs-sqrt/div differences) but skips the color accumulation and
    keeps every intermediate the reverse sweep (``_node_reverse``)
    consumes.  ``want_snell``: also compute the transmitted direction and
    its Snell record (non-last levels of transmitting scenes).

    Returns (rec, (px, py, pz), (rx, ry, rz), (tx, ty, tz) or None)."""
    ox, oy, oz = o
    vx, vy, vz = v

    hitm, is_tri = c["hitm"], c["is_tri"]
    cx, cy, cz, rr = gath_n[0:4]
    vlen2 = vx * vx + vy * vy + vz * vz
    ray_ok = vlen2 > 0.0
    ivl, vlen = _masked_rsqrt(vlen2, ray_ok)
    ux, uy, uz = vx * ivl, vy * ivl, vz * ivl

    tnx, tny, tnz = c["tn"]
    ndv = tnx * vx + tny * vy + tnz * vz
    ndv_ok = jnp.abs(ndv) > 0.0
    inv_ndv = 1.0 / jnp.where(ndv_ok, ndv, 1.0)
    ndo = tnx * ox + tny * oy + tnz * oz
    m_par = jnp.where(ndv_ok, (c["tnv0"] - ndo) * inv_ndv, 0.0)
    dist_tri = m_par * vlen

    dx, dy, dz = cx - ox, cy - oy, cz - oz
    ud = ux * dx + uy * dy + uz * dz
    disc = ud * ud - (dx * dx + dy * dy + dz * dz) + rr * rr
    disc_ok = disc > 0.0
    inv_sq, sq = _masked_rsqrt(disc, disc_ok)
    dist_sph = ud - sq

    bd = jnp.where(hitm, jnp.where(is_tri, dist_tri, dist_sph), 0.0)
    px, py, pz = ox + bd * ux, oy + bd * uy, oz + bd * uz

    d0x, d0y, d0z = px - cx, py - cy, pz - cz
    d0sq = d0x * d0x + d0y * d0y + d0z * d0z
    inv_d0, _ = _masked_rsqrt(d0sq, d0sq > 0.0)
    nx = jnp.where(hitm, jnp.where(is_tri, tnx, d0x * inv_d0), 0.0)
    ny = jnp.where(hitm, jnp.where(is_tri, tny, d0y * inv_d0), 0.0)
    nz = jnp.where(hitm, jnp.where(is_tri, tnz, d0z * inv_d0), 0.0)

    cosi = ux * nx + uy * ny + uz * nz
    rx = ux - 2.0 * cosi * nx
    ry = uy - 2.0 * cosi * ny
    rz = uz - 2.0 * cosi * nz

    lrec = []
    for li in range(nl):
        svx = lp[li][0] - px
        svy = lp[li][1] - py
        svz = lp[li][2] - pz
        d2 = svx * svx + svy * svy + svz * svz
        att = atten * (1.0 / (atten + d2))   # atten + d2 >= atten > 0
        inv_sl, _ = _masked_rsqrt(d2, d2 > 0.0)
        dot_ns = nx * svx + ny * svy + nz * svz
        dot_ur = ux * rx + uy * ry + uz * rz
        lrec.append((svx, svy, svz, att, inv_sl, dot_ns, dot_ur))

    rec = dict(vx=vx, vy=vy, vz=vz, ivl=ivl, vlen=vlen,
               ux=ux, uy=uy, uz=uz,
               ndv_ok=ndv_ok, inv_ndv=inv_ndv, m_par=m_par,
               dx=dx, dy=dy, dz=dz, ud=ud, disc_ok=disc_ok,
               inv_sq=inv_sq, bd=bd, px=px, py=py, pz=pz,
               d0x=d0x, d0y=d0y, d0z=d0z, inv_d0=inv_d0,
               nx=nx, ny=ny, nz=nz, cosi=cosi, rx=rx, ry=ry, rz=rz,
               lights=lrec)

    t_dir = None
    if want_snell:
        rho = c["rho"]
        modulus = 1.0 - rho * rho * (1.0 - cosi * cosi)
        mod_ok = modulus > 0.0
        inv_cosr, cosr = _masked_rsqrt(modulus, mod_ok)
        mod_f = jnp.where(mod_ok, 1.0, 0.0)
        coef = cosr + rho * cosi
        tx = (rho * ux - coef * nx) * mod_f
        ty = (rho * uy - coef * ny) * mod_f
        tz = (rho * uz - coef * nz) * mod_f
        rec.update(mod_ok=mod_ok, mod_f=mod_f, inv_cosr=inv_cosr, coef=coef)
        t_dir = (tx, ty, tz)
    return rec, (px, py, pz), (rx, ry, rz), t_dir


def _snell_reverse(c, rec, t_b):
    """Adjoint of the transmitted direction t = (rho*u - coef*n) * mod_f
    given its cotangent 3-tuple ``t_b``.  Returns (u_b, n_b, cosi_b)
    contributions (the transpose of the chain's child select)."""
    t_bx, t_by, t_bz = t_b
    rho = c["rho"]
    nx, ny, nz = rec["nx"], rec["ny"], rec["nz"]
    mod_f, coef = rec["mod_f"], rec["coef"]
    rho_mf = rho * mod_f
    u_b = (rho_mf * t_bx, rho_mf * t_by, rho_mf * t_bz)
    cmf = coef * mod_f
    n_b = (-cmf * t_bx, -cmf * t_by, -cmf * t_bz)
    coef_b = -mod_f * (t_bx * nx + t_by * ny + t_bz * nz)
    # coef = cosr + rho*cosi; cosr = safe_sqrt(modulus, mod_ok);
    # modulus = 1 - rho^2 (1 - cosi^2)
    cosi_b = rho * coef_b
    mod_b = 0.5 * rec["inv_cosr"] * coef_b      # inv_cosr self-masks
    cosi_b += mod_b * (2.0 * rho * rho) * rec["cosi"]
    return u_b, n_b, cosi_b


def _adjoint_tile_body(sph_ref, tri_ref, mat_ref, light_ref,
                       eye, vx0, vy0, vz0, bi_at, mid_at, lit_at,
                       gr, gg, gb,
                       *, ns: int, nt: int, m: int, nl: int, depth: int,
                       atten: float, want_trans: bool, shape, **_):
    """The replay adjoint for one pixel block: given per-level residual
    accessors (``bi_at(lv)``, ``mid_at(lv)``, ``lit_at(li, lv)`` -> pixel
    planes) and the L2 cotangent planes, returns the block's gradient sums
    as a list of scalars in ``grad_layout`` order (without the loss slot).

    The adjoint is HAND-WRITTEN (no ``jax.vjp``): a lean primal sweep keeps
    exactly the intermediates the reverse needs, every
    sqrt/divide/reciprocal adjoint reuses an already-computed reciprocal
    (one ``rsqrt`` yields both sqrt(x) = x*rsqrt(x) and the 0.5*inv^3
    adjoint factor), and the colour accumulation — whose value the kernel
    never needs — is skipped entirely.  Gradients are defined through fixed
    hit topology, identical to kernels/adjoint.py::replay_render's autodiff
    (parity asserted in tests/test_adjoint_fused.py)."""
    f32 = jnp.float32

    def full(x):
        return jnp.full(shape, x, f32)

    # ---- per-level constants (fixed topology; no gradients flow here) ----
    consts = []
    for lv in range(depth + 1):
        bik = bi_at(lv)
        midl = mid_at(lv)
        hitm = bik >= 0.0
        is_tri = bik < float(nt)

        def tri_attr(i, c):
            sel = bik == i.astype(f32)
            return (jnp.where(sel, tri_ref[i, 3], c[0]),
                    jnp.where(sel, tri_ref[i, 4], c[1]),
                    jnp.where(sel, tri_ref[i, 5], c[2]),
                    jnp.where(sel, tri_ref[i, 16], c[3]))

        tnx, tny, tnz, tnv0 = _sweep_loop(nt, tri_attr, (full(0.0),) * 4)

        def mat_attr(j, c):
            sel = midl == j.astype(f32)
            return (jnp.where(sel, mat_ref[j, 9], c[0]),
                    jnp.where(sel, mat_ref[j, 10], c[1]),
                    jnp.where(sel, mat_ref[j, 11], c[2]),
                    jnp.where(sel, mat_ref[j, 12], c[3]),
                    jnp.where(sel, mat_ref[j, 15], c[4]))

        trn_r, trn_g, trn_b, rho, t_any = _sweep_loop(
            m, mat_attr, (full(0.0),) * 5)
        take_t = t_any > 0.5
        lits = [lit_at(li, lv) > 0.5 for li in range(nl)]
        consts.append(dict(bik=bik, midl=midl, hitm=hitm, is_tri=is_tri,
                           tn=(tnx, tny, tnz), tnv0=tnv0,
                           trn=(trn_r, trn_g, trn_b), rho=rho,
                           take_t=take_t, lits=lits))

    # Throughput chain: depends only on transparency (not a fit param), so it
    # is a per-level constant (MySdlApplication.cpp:1238-1246 weights).
    thr = [(full(1.0), full(1.0), full(1.0))]
    for lv in range(depth):
        c = consts[lv]
        tr, tg, tb = thr[-1]
        wr = jnp.where(c["take_t"], c["trn"][0], 1.0 - c["trn"][0])
        wg = jnp.where(c["take_t"], c["trn"][1], 1.0 - c["trn"][1])
        wb = jnp.where(c["take_t"], c["trn"][2], 1.0 - c["trn"][2])
        one = full(1.0)
        thr.append((tr * jnp.where(c["hitm"], wr, one),
                    tg * jnp.where(c["hitm"], wg, one),
                    tb * jnp.where(c["hitm"], wb, one)))

    # Light colours (constant scalars).
    lcol = [(light_ref[li, 3], light_ref[li, 4], light_ref[li, 5])
            for li in range(nl)]

    # Per-level sphere/material selection masks (constants).
    sph_sel = [[consts[lv]["bik"] == float(nt + i) for i in range(ns)]
               for lv in range(depth + 1)]
    mat_sel = [[consts[lv]["midl"] == float(j) for j in range(m)]
               for lv in range(depth + 1)]

    # ---- pre-gathered differentiable planes (sphere centre/radius and
    # material ambient/diffuse/specular of each pixel's winner) ----
    gath = []
    for lv in range(depth + 1):
        cx, cy, cz, rr = full(0.0), full(0.0), full(0.0), full(0.0)
        for i in range(ns):
            sel = sph_sel[lv][i]
            cx = jnp.where(sel, sph_ref[i, 0], cx)
            cy = jnp.where(sel, sph_ref[i, 1], cy)
            cz = jnp.where(sel, sph_ref[i, 2], cz)
            rr = jnp.where(sel, sph_ref[i, 3], rr)
        fields = [full(0.0) for _ in range(9)]
        for j in range(m):
            sel = mat_sel[lv][j]
            for k in range(9):
                fields[k] = jnp.where(sel, mat_ref[j, k], fields[k])
        gath.append([cx, cy, cz, rr] + fields)
    lp = [[full(light_ref[li, 0]), full(light_ref[li, 1]),
           full(light_ref[li, 2])] for li in range(nl)]

    # ---- hand-written primal sweep ----------------------------------------
    # Mirrors kernels/adjoint.py::replay_render value-for-value (the shared
    # per-node helper _node_primal) but skips the colour accumulation and
    # keeps every intermediate the reverse sweep consumes.
    P = []
    o = (full(eye[0]), full(eye[1]), full(eye[2]))
    v = (vx0, vy0, vz0)
    for lv in range(depth + 1):
        c = consts[lv]
        hitm = c["hitm"]
        want_snell = lv < depth and want_trans
        rec, p, r_dir, t_dir = _node_primal(
            c, gath[lv], lp, o, v, nl=nl, atten=atten,
            want_snell=want_snell)
        if lv < depth:
            if want_trans:
                take_t = c["take_t"]
                nv = tuple(jnp.where(take_t, t, r)
                           for t, r in zip(t_dir, r_dir))
            else:
                # no transmitting material (static): the chain always
                # reflects — bit-identical to the gated selects above
                nv = r_dir
            v = tuple(jnp.where(hitm, nvi, 0.0) for nvi in nv)
            o = p
        P.append(rec)

    # ---- hand-written reverse sweep ---------------------------------------
    # Cotangents flow level depth -> 0; the per-node math lives in
    # _node_reverse.  Parameter cotangents land in d_gath[lv] (13 planes,
    # same layout as gath) and d_lp.
    d_gath = [[full(0.0) for _ in range(13)] for _ in range(depth + 1)]
    d_lp = [[full(0.0) for _ in range(3)] for _ in range(nl)]
    pbx = pby = pbz = full(0.0)   # cotangent of p (= next level's o)
    vbx = vby = vbz = full(0.0)   # cotangent of next level's v input
    for lv in range(depth, -1, -1):
        c = consts[lv]
        rec = P[lv]
        hitm = c["hitm"]

        zero3 = (full(0.0), full(0.0), full(0.0))
        inflow = dict(p=(pbx, pby, pbz), u=zero3, n=zero3,
                      r=zero3, cosi=full(0.0))

        # child-ray select (v_{lv+1} = where(hitm, nv, 0); nv = t or r)
        if lv < depth:
            vmx = jnp.where(hitm, vbx, 0.0)
            vmy = jnp.where(hitm, vby, 0.0)
            vmz = jnp.where(hitm, vbz, 0.0)
            if want_trans:
                take_t = c["take_t"]
                t_b = (jnp.where(take_t, vmx, 0.0),
                       jnp.where(take_t, vmy, 0.0),
                       jnp.where(take_t, vmz, 0.0))
                r_b = (jnp.where(take_t, 0.0, vmx),
                       jnp.where(take_t, 0.0, vmy),
                       jnp.where(take_t, 0.0, vmz))
                u_b, n_b, cosi_b = _snell_reverse(c, rec, t_b)
                inflow.update(u=u_b, n=n_b, r=r_b, cosi=cosi_b)
            else:
                inflow.update(r=(vmx, vmy, vmz))

        tr_, tg_, tb_ = thr[lv]
        (pbx, pby, pbz), (vbx, vby, vbz) = _node_reverse(
            c, rec, gath[lv], d_gath[lv], d_lp, lcol,
            (tr_ * gr, tg_ * gg, tb_ * gb), atten, nl, inflow)

    # ---- gather transpose: level-summed masked cotangent planes, then one
    # block reduction per (entity, field) ----
    def lvsum(idx, sel_per_lv):
        acc = full(0.0)
        for lv in range(depth + 1):
            acc = acc + jnp.where(sel_per_lv[lv], 1.0, 0.0) * d_gath[lv][idx]
        return jnp.sum(acc)

    sums = []
    for i in range(ns):
        sel = [sph_sel[lv][i] for lv in range(depth + 1)]
        sums += [lvsum(k, sel) for k in range(4)]
    for j in range(m):
        sel = [mat_sel[lv][j] for lv in range(depth + 1)]
        sums += [lvsum(4 + k, sel) for k in range(9)]
    for li in range(nl):
        sums += [jnp.sum(d_lp[li][k]) for k in range(3)]
    return sums


def _bwd_packed_kernel(sph_ref, tri_ref, mat_ref, light_ref, misc_ref,
                       vx_ref, vy_ref, vz_ref,
                       cr_ref, cg_ref, cb_ref,
                       tr_ref, tg_ref, tb_ref, mask_ref, pk_ref,
                       out_ref, *, g_scale: float, pack, width: int, **st):
    """Phase 2 of the packed two-phase fwd+bwd: the L2 cotangent
    ``g = g_scale * mask * (img - target)`` and the masked squared-error
    sum are formed in the kernel's prologue, the packed residual plane is
    unpacked per level, and the hand-written replay adjoint runs.  The mask
    is applied once, to both the loss and the cotangent, so the gradient is
    exactly that of the returned loss for any mask."""
    eye = (misc_ref[0], misc_ref[1], misc_ref[2])
    mask = mask_ref[...]
    dr_raw = cr_ref[...] - tr_ref[...]
    dg_raw = cg_ref[...] - tg_ref[...]
    db_raw = cb_ref[...] - tb_ref[...]
    dr, dg, db = dr_raw * mask, dg_raw * mask, db_raw * mask
    tile_loss = jnp.sum(dr * dr_raw + dg * dg_raw + db * db_raw)

    nl = st["nl"]
    unpacked = [unpack_level(pk_ref[lv, :], nl, pack)
                for lv in range(st["depth"] + 1)]
    sums = _adjoint_tile_body(
        sph_ref, tri_ref, mat_ref, light_ref,
        eye, vx_ref[...], vy_ref[...], vz_ref[...],
        bi_at=lambda lv: unpacked[lv][0],
        mid_at=lambda lv: unpacked[lv][1],
        lit_at=lambda li, lv: unpacked[lv][2][li],
        gr=g_scale * dr, gg=g_scale * dg, gb=g_scale * db,
        shape=vx_ref.shape, **st)
    out_ref[...] = _partials_row([tile_loss] + sums, width)


def _recompute_bwd_kernel(sph_ref, tri_ref, mat_ref, light_ref, misc_ref,
                          vx_ref, vy_ref, vz_ref, gr_ref, gg_ref, gb_ref,
                          out_ref, *, width: int, **st):
    """Recompute-forward + replay-adjoint in one launch, with the
    cotangent supplied from outside (``gr/gg/gb`` planes).  This is the
    per-sample backward of the supersampled fit: the forward chain re-traces
    the block into registers (its residuals never reach device memory) and
    the hand adjoint consumes them at once."""
    ops = _make_tile_ops(sph_ref, tri_ref, mat_ref, light_ref, misc_ref,
                         vx_ref.shape, **st)
    eye = (misc_ref[0], misc_ref[1], misc_ref[2])
    vx0, vy0, vz0 = vx_ref[...], vy_ref[...], vz_ref[...]
    _, levels = _chain_forward(ops, eye, vx0, vy0, vz0, nl=st["nl"],
                               depth=st["depth"],
                               want_trans=st["want_trans"], record=True)
    sums = _adjoint_tile_body(
        sph_ref, tri_ref, mat_ref, light_ref, eye, vx0, vy0, vz0,
        bi_at=lambda lv: levels[lv]["bi"],
        mid_at=lambda lv: levels[lv]["mid"],
        lit_at=lambda li, lv: jnp.where(levels[lv]["lits"][li], 1.0, 0.0),
        gr=gr_ref[...], gg=gg_ref[...], gb=gb_ref[...],
        shape=vx_ref.shape, **st)
    out_ref[...] = _partials_row([jnp.float32(0.0)] + sums, width)


def _backward_call(kernel, name, packed, scene, config, planes, *,
                   interpret, extra_in=(), block=None, **kw):
    """pallas_call of a backward kernel over padded flat planes: each
    program writes one row of partial sums; returns (loss sum,
    compacted-scene gradient tables).  ``block``: (pixels, warps) per
    program, default ``render_pallas.BWD_BLOCK``."""
    bsize, warps = block or render_pallas.BWD_BLOCK
    (p,) = planes[0].shape
    st = kernel_statics(packed, scene, config)
    _, width = grad_layout(st["ns"], st["m"], st["nl"])
    grid = p // bsize
    tabs = tables(packed)
    partials = triton_call(
        functools.partial(kernel, width=width, **kw, **st), grid=(grid,),
        in_specs=([whole(t) for t in tabs]
                  + [plane_spec(bsize)] * len(planes)
                  + [pl.BlockSpec((x.shape[0], bsize), lambda i: (0, i))
                     for x in extra_in]),
        out_specs=pl.BlockSpec((None, width), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((grid, width), jnp.float32),
        interpret=interpret, num_warps=warps, name=name,
    )(*tabs, *planes, *extra_in)
    return reduce_partials(partials, st["ns"], st["m"], st["nl"],
                           scene.num_spheres)


def twophase_loss_grads_pallas(scene: FlatScene, camera: Camera,
                               config: RenderConfig, target,
                               mask: Optional[Any] = None,
                               denom: Optional[float] = None,
                               interpret: Optional[bool] = None,
                               pts: Optional[Any] = None,
                               prep: Optional[Dict[str, Any]] = None):
    """Two-phase fwd+bwd for chain-exact single-sample scenes: phase 1
    renders the image AND the packed residuals (one plane per bounce level —
    render_pallas.py::pack_widths), phase 2 forms the L2 cotangent + loss
    in-kernel and runs the hand adjoint.  Returns ``(sq_err_sum, grads_c)``:
    the mask-weighted squared-error sum ``sum(mask * (img - target)^2)``
    (callers divide by the pixel count / psum it) and the compacted-scene
    gradient tables.

    ``mask``: optional [H, W] weight plane (1 = real pixel); sharded
    row-band callers pass ``jj < H_image`` to zero mesh-padding rows.
    ``denom``: the loss normalizer (default ``H*W*3``) — the cotangent is
    ``(2/denom) * mask * (img - target)``."""
    if not scene.chain_exact:
        raise ValueError("the packed two-phase backward replays the bounce "
                         "chain; fractional-transparency scenes "
                         "differentiate through diff.fit.l2_loss")
    interpret = use_interpret(interpret)
    scene = compact_scene(scene)
    w, h = config.width, config.height
    if denom is None:
        denom = float(h * w * 3)

    packed = pack_scene_for(scene, camera)
    if prep is None:
        prep = prepare_fit_inputs(camera, config, target, mask=mask,
                                  pts=pts)
    else:
        _check_prep(prep, target, mask, pts)
    vx, vy, vz = prep["vx"], prep["vy"], prep["vz"]
    pack = pack_widths(packed["tri"].shape[0], packed["sph"].shape[0],
                       scene.num_materials, scene.num_lights)

    # ---- phase 1: forward + packed residuals (padded planes throughout) --
    cr, cg, cb, pk = render_forward(packed, scene, config, vx, vy, vz,
                                    interpret=interpret, pack=pack)
    # ---- phase 2: cotangent prologue + replay adjoint ----
    return _backward_call(
        _bwd_packed_kernel, "adjoint_twophase", packed, scene, config,
        (vx, vy, vz, cr, cg, cb, prep["tr"], prep["tg"], prep["tb"],
         prep["mask"]), extra_in=(pk,), interpret=interpret,
        g_scale=2.0 / denom, pack=pack)


def recompute_grads_pallas(scene: FlatScene, camera: Camera,
                           config: RenderConfig, g,
                           interpret: Optional[bool] = None,
                           pts: Optional[Any] = None) -> Dict[str, Any]:
    """Single-launch backward with an external cotangent ``g`` [H,W,3]:
    re-traces the chain forward in registers and runs the hand adjoint.
    Returns the compacted-scene gradient tables.  Used by the supersampled
    fit path (one launch per sample, no residual in device memory)."""
    if not scene.chain_exact:
        raise ValueError("the recompute backward replays the bounce chain; "
                         "fractional-transparency scenes differentiate "
                         "through diff.fit.l2_loss")
    interpret = use_interpret(interpret)
    scene = compact_scene(scene)
    w, h = config.width, config.height
    packed = pack_scene_for(scene, camera)
    if pts is None:
        pts = screen_points(camera, w, h)
    g = jnp.asarray(g, jnp.float32)
    planes = ray_planes(camera, pts, PLANE_MULT) + tuple(
        pad_plane(g[..., k], PLANE_MULT) for k in range(3))
    _, grads_c = _backward_call(_recompute_bwd_kernel, "adjoint_recompute",
                                packed, scene, config, planes,
                                interpret=interpret)
    return grads_c


def prepare_fit_inputs(camera: Camera, config: RenderConfig, target,
                       mask: Optional[Any] = None,
                       pts: Optional[Any] = None) -> Dict[str, Any]:
    """Precompute the padded per-pixel input planes of the two-phase fit:
    primary-ray directions, target RGB and the pixel mask — everything that
    depends only on (camera, config, target), NOT on the fit parameters.

    In a fit loop these are step-invariant, but XLA does not hoist them out
    of a ``lax.scan``/training-loop body.  Call this once and pass the
    result as ``prep=`` to ``twophase_loss_grads_pallas`` /
    ``fit_value_and_grad`` — the per-step work is then only the tiny
    scene-table packing plus the kernels."""
    w, h = config.width, config.height
    target0, mask0, pts0 = target, mask, pts   # as-passed, for provenance
    if pts is None:
        pts = screen_points(camera, w, h)
    vx, vy, vz = ray_planes(camera, pts, PLANE_MULT)
    target = jnp.asarray(target, jnp.float32)
    tr, tg, tb = (pad_plane(target[..., k], PLANE_MULT) for k in range(3))
    if mask is None:
        mask = jnp.ones((h, w), jnp.float32)
    mask = pad_plane(jnp.asarray(mask, jnp.float32), PLANE_MULT)
    # provenance: the exact objects this prep was built from, so a caller
    # passing a DIFFERENT target/mask alongside a stale prep gets an error
    # instead of silently computing loss/grads against the old target
    # (the strong refs also pin the ids against reuse)
    return dict(vx=vx, vy=vy, vz=vz, tr=tr, tg=tg, tb=tb, mask=mask,
                src=dict(target=target0, mask=mask0, pts=pts0))


def _check_prep(prep, target, mask, pts):
    """Raise if ``prep`` was built from a target/mask/pts object DIFFERENT
    from the one this call passes (identity check — rebuild the prep, or
    pass None, when the target changes).

    LIMITATION: a TRACED target/mask/pts cannot be identity-checked, so it
    is skipped (jitting a step with the target as a jit argument alongside
    a matching prep is legitimate).  The flip side: if such a caller feeds
    a DIFFERENT target array at call time, the kernel still uses the prep's
    planes with no error.  When the target varies across calls, rebuild
    the prep per target."""
    src = prep["src"]
    for name, got in (("target", target), ("mask", mask), ("pts", pts)):
        if isinstance(got, jax.core.Tracer):
            continue
        if got is not None and src[name] is not got:
            raise ValueError(
                f"prep= was built from a different `{name}` object than "
                f"this call passes; prepare_fit_inputs() again for the new "
                f"{name} (or pass {name}=None to use the prep's planes)")


def _sphere_take(scene: FlatScene):
    """Indices of compacted sphere rows in the original arrays (None when the
    masks are traced and no compaction happened)."""
    try:
        sv = np.asarray(scene.sph_valid)
        tv = np.asarray(scene.tri_valid)
    except Exception:
        return None
    if sv.all() and tv.all():
        return None
    return np.nonzero(sv)[0]


def grads_to_fitparams(params: FitParams, scene_full: FlatScene,
                       grads_c: Dict[str, Any]) -> FitParams:
    """Scatter compacted-scene gradient tables back onto the (possibly
    padded) ``FitParams`` leaves."""
    take = _sphere_take(scene_full)
    if take is None:
        d_center = grads_c["sph_center"]
        d_radius = grads_c["sph_radius"]
    else:
        d_center = jnp.zeros_like(params.sph_center).at[take].set(
            grads_c["sph_center"])
        d_radius = jnp.zeros_like(params.sph_radius).at[take].set(
            grads_c["sph_radius"])
    return FitParams(sph_center=d_center, sph_radius=d_radius,
                     light_pos=grads_c["light_pos"],
                     mat_diffuse=grads_c["mat_diffuse"],
                     mat_specular=grads_c["mat_specular"],
                     mat_ambient=grads_c["mat_ambient"])


def fit_value_and_grad(params: FitParams, scene: FlatScene, camera: Camera,
                       config: RenderConfig, target,
                       interpret: Optional[bool] = None, key=None,
                       prep: Optional[Dict[str, Any]] = None):
    """(loss, d loss/d params) of the L2 photometric loss with the Pallas
    kernels — the fast path for the BASELINE config-4 fit and the fwd+bwd
    benchmark.  The path is chosen from the scene and config:

      * chain-exact, one sample: the packed two-phase kernels
        (``twophase_loss_grads_pallas``);
      * chain-exact, supersampled (``config.samples > 1`` / ``force_jitter``,
        adaptive or not): the image is the mean of S jittered single-sample
        kernel renders (same PRNG stream as the core renderer, so targets
        rendered by either forward match); the backward runs one
        recompute-adjoint launch per sample (``recompute_grads_pallas``)
        with cotangent g/S and sums the gradient tables.  For
        ``config.adaptive`` the per-sample acceptance masks and the
        early-exit divisor are recorded by the forward scan as
        fixed-topology residuals and each sample's cotangent is weighted by
        accept_k / divisor;
      * fractional transparency (the bounce tree): XLA autodiff of the core
        renderer, ``jax.value_and_grad(diff.fit.l2_loss)``.

    Equivalent to ``jax.value_and_grad(l2_loss_pallas)`` (kernels/adjoint.py)
    restricted to the ``FitParams`` leaves; scene/camera are constants."""
    scene_full = params.into_scene(scene)
    use_jitter = config.samples > 1 or config.force_jitter
    if prep is not None and (use_jitter or not scene_full.chain_exact):
        raise ValueError("prep= is only supported on the single-sample "
                         "chain path")
    if not scene_full.chain_exact:
        return jax.value_and_grad(l2_loss)(params, scene, camera, config,
                                           target)
    if not use_jitter:
        denom = float(config.height * config.width * 3)
        sq_sum, grads_c = twophase_loss_grads_pallas(
            scene_full, camera, config, target, denom=denom,
            interpret=interpret, prep=prep)
        return sq_sum / denom, grads_to_fitparams(params, scene_full,
                                                  grads_c)

    S = config.samples
    if key is None:
        key = jax.random.PRNGKey(config.seed)
    keys = jax.random.split(key, S)
    cfg1 = dataclasses.replace(config, samples=1, force_jitter=False)
    pts0 = screen_points(camera, config.width, config.height)
    h, w = config.height, config.width

    from .render_pallas import render_image_pallas

    def jittered(key_k):
        return pts0 + sample_jitter(key_k, pts0.shape[0],
                                    config.jitter_scale, dtype=pts0.dtype)

    def render_sample(key_k):
        return render_image_pallas(scene_full, camera, cfg1,
                                   interpret=interpret, pts=jittered(key_k))

    if config.adaptive:
        # Fixed-topology adjoint of the adaptive supersampler
        # (MySdlApplication.cpp:1294-1311 emulation): the per-sample
        # acceptance masks and the early-exit divisor are DISCRETE
        # outcomes, exactly like hit ids and lit flags — record them in
        # the forward scan, then weight each sample's cotangent by
        # accept_k / divisor in the backward.  This matches jax.grad of
        # the core emulation (the convergence test and divisor carry no
        # continuous dependence on the parameters).
        small = config.small_number

        def fwd_body_ad(carry, inp):
            accum, divisor, done = carry
            k, key_k = inp
            img_s = render_sample(key_k)
            accept = jnp.logical_not(done)
            accum_after = jnp.where(done[..., None], accum, accum + img_s)
            d = k * accum_after - (k + 1.0) * accum
            dnorm = jnp.sqrt(jnp.sum(d * d, -1))
            newly = jnp.logical_and(accept, dnorm < small * k * (k + 1.0))
            divisor = jnp.where(newly, k, divisor)
            done = jnp.logical_or(done, newly)
            return (accum_after, divisor, done), accept

        ks = jnp.arange(S, dtype=jnp.float32)
        init = (jnp.zeros((h, w, 3), jnp.float32),
                jnp.full((h, w), float(S), jnp.float32),
                jnp.zeros((h, w), bool))
        (accum, divisor, _), accepts = jax.lax.scan(fwd_body_ad, init,
                                                    (ks, keys))
        img = accum / divisor[..., None]
        diff = img - target
        loss = jnp.mean(diff * diff)
        g = (2.0 / diff.size) * diff

        def bwd_body(carry, inp):
            key_k, accept = inp
            wk = jnp.where(accept, 1.0, 0.0) / divisor
            grads_s = recompute_grads_pallas(
                scene_full, camera, cfg1, g * wk[..., None],
                interpret=interpret, pts=jittered(key_k))
            return jax.tree_util.tree_map(jnp.add, carry, grads_s), None

        bwd_xs = (keys, accepts)
    else:
        def fwd_body(carry, k):
            return carry + render_sample(k), None

        img_sum, _ = jax.lax.scan(
            fwd_body, jnp.zeros((h, w, 3), jnp.float32), keys)
        img = img_sum / S
        diff = img - target
        loss = jnp.mean(diff * diff)
        g = (2.0 / (diff.size * S)) * diff

        def bwd_body(carry, k):
            grads_s = recompute_grads_pallas(scene_full, camera, cfg1, g,
                                             interpret=interpret,
                                             pts=jittered(k))
            return jax.tree_util.tree_map(jnp.add, carry, grads_s), None

        bwd_xs = keys

    sc = compact_scene(scene_full)
    ns_c, m_c, nl_c = sc.num_spheres, sc.num_materials, sc.num_lights
    zeros = dict(sph_center=jnp.zeros((ns_c, 3), jnp.float32),
                 sph_radius=jnp.zeros((ns_c,), jnp.float32),
                 mat_ambient=jnp.zeros((m_c, 3), jnp.float32),
                 mat_diffuse=jnp.zeros((m_c, 3), jnp.float32),
                 mat_specular=jnp.zeros((m_c, 3), jnp.float32),
                 light_pos=jnp.zeros((nl_c, 3), jnp.float32))
    grads_c, _ = jax.lax.scan(bwd_body, zeros, bwd_xs)
    return loss, grads_to_fitparams(params, scene_full, grads_c)
