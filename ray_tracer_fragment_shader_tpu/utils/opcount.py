"""Exact per-pixel op counts of the Pallas kernel bodies, derived from their
jaxprs.  The counts do not depend on the device: they count jaxpr
operations per pixel (one elementwise op on one pixel is one op), not
FLOPs and not machine instructions.

Every kernel is a plain traceable function, so the counts are *derived*:
trace the block body with ``jax.make_jaxpr``, dead-code-eliminate, and walk
the jaxpr, classifying each pixel-plane equation into an op class.
``lax.scan`` bodies (the loops over primitives/materials) multiply by their
trip count.

Counting rules (what "one op" means):
  * only equations whose OUTPUT spans the pixel block count (scalar table
    arithmetic is done once per program, not per pixel; the traced block is
    strictly larger than every scene table, so the size test is exact);
  * reductions (``reduce_sum`` etc.) count their INPUT size;
  * shape-only equations (broadcast, reshape, transpose, convert between
    identical dtypes) are free;
  * ``integer_pow[y=n]`` counts n-1 multiplies;
  * residual loads and stores are memory traffic, not ops, and are
    excluded.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import numpy as np

# jaxpr primitive -> op class
_CLASS = {
    "add": "basic", "sub": "basic", "mul": "basic", "neg": "basic",
    "max": "basic", "min": "basic", "floor": "basic", "ceil": "basic",
    "round": "basic", "and": "basic", "or": "basic", "not": "basic",
    "xor": "basic", "iota": "basic",
    "lt": "cmp", "le": "cmp", "gt": "cmp", "ge": "cmp", "eq": "cmp",
    "ne": "cmp",
    "select_n": "select",
    "abs": "abs", "sign": "sign",
    "rsqrt": "rsqrt", "sqrt": "sqrt", "div": "div",
    "is_finite": "cmp",
}
_FREE = {
    "broadcast_in_dim", "reshape", "squeeze", "expand_dims", "transpose",
    "copy", "stop_gradient", "slice", "dynamic_slice", "concatenate",
    "pad", "rev", "gather", "dynamic_update_slice", "scatter-add",
    "scatter", "convert_element_type", "empty", "split",
}
_REDUCE = {"reduce_sum": "basic", "reduce_max": "basic",
           "reduce_min": "basic", "argmax": "basic", "argmin": "basic"}


def _classify(eqn, mult: float, pixel_size: int, counts: Dict[str, float]):
    name = eqn.primitive.name
    if name in _REDUCE:
        size = max(int(np.prod(v.aval.shape)) for v in eqn.invars
                   if hasattr(v.aval, "shape"))
        if size >= pixel_size:
            counts[_REDUCE[name]] = counts.get(_REDUCE[name], 0.0) \
                + mult * size / pixel_size
        return
    out_size = int(np.prod(eqn.outvars[0].aval.shape)) \
        if eqn.outvars[0].aval.shape else 1
    if out_size < pixel_size:
        return  # scalar-core / table arithmetic: free
    per_pix = mult * out_size / pixel_size
    if name == "integer_pow":
        counts["basic"] = counts.get("basic", 0.0) \
            + per_pix * max(abs(eqn.params["y"]) - 1, 1)
        return
    if name in _FREE:
        return
    cls = _CLASS.get(name)
    if cls is None:
        counts["other:" + name] = counts.get("other:" + name, 0.0) + per_pix
        return
    counts[cls] = counts.get(cls, 0.0) + per_pix


def _walk(jaxpr, mult: float, pixel_size: int, counts: Dict[str, float]):
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan":
            _walk(eqn.params["jaxpr"].jaxpr,
                  mult * eqn.params["length"], pixel_size, counts)
        elif name == "while":
            raise ValueError("while_loop has no static trip count; "
                             "kernels must use fori_loop/scan")
        elif name == "cond":
            # max over branches (the kernels have none; defensive)
            branch_counts = []
            for br in eqn.params["branches"]:
                c: Dict[str, float] = {}
                _walk(br.jaxpr, mult, pixel_size, c)
                branch_counts.append(c)
            worst = max(branch_counts, key=lambda c: sum(c.values()),
                        default={})
            for k, v in worst.items():
                counts[k] = counts.get(k, 0.0) + v
        else:
            recursed = False
            for v in eqn.params.values():
                if hasattr(v, "jaxpr"):          # pjit, custom_*_call, ...
                    _walk(v.jaxpr, mult, pixel_size, counts)
                    recursed = True
            if not recursed:
                _classify(eqn, mult, pixel_size, counts)


def jaxpr_op_counts(fn, *args, pixel_size: int, return_jaxpr: bool = False):
    """Per-pixel op counts {class: count} of ``fn(*args)`` after DCE.
    ``return_jaxpr``: also return the DCE'd jaxpr (for the live-plane
    analysis)."""
    closed = jax.make_jaxpr(fn)(*args)
    from jax._src.interpreters import partial_eval as pe
    jaxpr, _ = pe.dce_jaxpr(closed.jaxpr,
                            [True] * len(closed.jaxpr.outvars))
    counts: Dict[str, float] = {}
    _walk(jaxpr, 1.0, pixel_size, counts)
    if return_jaxpr:
        return counts, jaxpr
    return counts


def _live_planes(jaxpr, pixel_size: int) -> int:
    """Approximate MAX simultaneously-live pixel-sized values ("planes")
    across ``jaxpr`` in traced order — a working-set estimate: with one
    pixel per thread, each live plane is about one 32-bit register.  The
    compiler reschedules, so this is an estimate of register pressure,
    not an exact register count.
    Scan bodies contribute (outer live at the scan site + body max)."""
    def is_plane(v):
        shape = getattr(getattr(v, "aval", None), "shape", None)
        return shape is not None and int(np.prod(shape)) >= pixel_size

    last_use: Dict[int, int] = {}
    n = len(jaxpr.eqns)
    for t, eqn in enumerate(jaxpr.eqns):
        for v in eqn.invars:
            if not hasattr(v, "count"):
                continue  # literals
            last_use[id(v)] = t
    for v in jaxpr.outvars:
        if hasattr(v, "count"):
            last_use[id(v)] = n
    live = {id(v) for v in jaxpr.invars
            if is_plane(v) and id(v) in last_use}
    peak = len(live)
    for t, eqn in enumerate(jaxpr.eqns):
        inner = 0
        for v in eqn.params.values():
            if hasattr(v, "jaxpr"):
                inner = max(inner, _live_planes(v.jaxpr, pixel_size))
        if eqn.primitive.name == "scan":
            inner = max(inner, _live_planes(eqn.params["jaxpr"].jaxpr,
                                            pixel_size))
        for v in eqn.outvars:
            if is_plane(v) and id(v) in last_use:
                live.add(id(v))
        peak = max(peak, len(live) + inner)
        for v in eqn.invars:
            if hasattr(v, "count") and last_use.get(id(v)) == t:
                live.discard(id(v))
    return peak


# ---------------------------------------------------------------------------
# Kernel-specific entry points
# ---------------------------------------------------------------------------

_TRACE_SHAPE = (256,)  # larger than every scene table => exact size test


@functools.lru_cache(maxsize=16)
def _counts_cached(ns, nt, m, nl, want_trans, depth, atten, small,
                   white_id, black_id):
    # The traced program depends only on the table SHAPES and the static
    # flags, never on the values — dummy tables suffice.
    import jax.numpy as jnp

    from ..kernels.adjoint_fused import _adjoint_tile_body
    from ..kernels.render_pallas import (LIGHT_COLS, MAT_COLS, MISC_COLS,
                                         SPH_COLS, TRI_COLS, _chain_forward,
                                         _make_tile_ops)
    shape = _TRACE_SHAPE
    pixel_size = int(np.prod(shape))
    plane = jnp.ones(shape, jnp.float32)
    tabs = (jnp.ones((max(ns, 1), SPH_COLS), jnp.float32),
            jnp.ones((max(nt, 1), TRI_COLS), jnp.float32),
            jnp.ones((max(m, 1), MAT_COLS), jnp.float32),
            jnp.ones((max(nl, 1), LIGHT_COLS), jnp.float32),
            jnp.ones((MISC_COLS,), jnp.float32))

    def fwd_fn(sph, tri, mat, light, misc, vx, vy, vz):
        ops = _make_tile_ops(sph, tri, mat, light, misc, shape,
                             ns=ns, nt=nt, m=m, nl=nl, small=small,
                             atten=atten, white_id=white_id,
                             black_id=black_id, want_trans=want_trans)
        return _chain_forward(ops, (misc[0], misc[1], misc[2]), vx, vy, vz,
                              nl=nl, depth=depth, want_trans=want_trans)[0]

    fwd, fwd_jaxpr = jaxpr_op_counts(
        fwd_fn, *tabs, plane, plane, plane,
        pixel_size=pixel_size, return_jaxpr=True)
    fwd_live = _live_planes(fwd_jaxpr, pixel_size)

    levels = depth + 1
    res = jnp.zeros((levels,) + shape, jnp.float32)
    lit = jnp.zeros((max(nl, 1) * levels,) + shape, jnp.float32)

    def bwd_fn(sph, tri, mat, light, misc,
               vx, vy, vz, bi, mid, lit, cr, cg, cb, tr, tg, tb, mask):
        # L2 loss + cotangent formation (the two-phase kernel's prologue) ...
        dr_raw, dg_raw, db_raw = cr - tr, cg - tg, cb - tb
        dr, dg, db = dr_raw * mask, dg_raw * mask, db_raw * mask
        tile_loss = jnp.sum(dr * dr_raw + dg * dg_raw + db * db_raw)
        # ... then the hand-written replay adjoint
        g = 2e-6
        sums = _adjoint_tile_body(
            sph, tri, mat, light, (misc[0], misc[1], misc[2]), vx, vy, vz,
            bi_at=lambda lv: bi[lv], mid_at=lambda lv: mid[lv],
            lit_at=lambda li, lv: lit[li * levels + lv],
            gr=g * dr, gg=g * dg, gb=g * db,
            ns=ns, nt=nt, m=m, nl=nl, depth=depth, atten=atten,
            want_trans=want_trans, shape=shape)
        return [tile_loss] + sums

    bwd, bwd_jaxpr = jaxpr_op_counts(
        bwd_fn, *tabs, plane, plane, plane, res, res, lit,
        plane, plane, plane, plane, plane, plane, plane,
        pixel_size=pixel_size, return_jaxpr=True)
    bwd_live = _live_planes(bwd_jaxpr, pixel_size)
    return fwd, bwd, fwd_live, bwd_live


def _cached_for(scene, config):
    ns = int(np.asarray(scene.sph_valid).sum())
    nt = int(np.asarray(scene.tri_valid).sum())
    return _counts_cached(ns, nt, scene.num_materials, scene.num_lights,
                          bool(scene.has_transmission), config.max_depth,
                          float(config.attenuation_factor),
                          float(config.small_number),
                          int(scene.checker_mats[0]),
                          int(scene.checker_mats[1]))


def kernel_op_counts(scene, config) -> Tuple[Dict[str, float],
                                             Dict[str, float]]:
    """(forward, backward) per-pixel op-class counts of the chain forward
    body and the two-phase loss+adjoint body, traced from the actual kernel
    code.  Cached per (dims, config)."""
    return _cached_for(scene, config)[:2]


def kernel_live_planes(scene, config) -> Tuple[int, int]:
    """(forward, backward) max-live pixel-plane estimates of the kernel
    bodies (see ``_live_planes``)."""
    return _cached_for(scene, config)[2:]
