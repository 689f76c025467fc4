"""Float64 fixed-topology reference gradients for the kernel fit path.

The kernel adjoint and XLA autodiff of the core renderer agree only up to
the few decision-boundary pixels where the f32 kernel and the f32 core pick
different hits.  And on silhouettes the fixed-topology gradient itself is
ill-conditioned: a grazing sphere hit has d(distance)/d(centre) ~
1/sqrt(disc) with ``disc`` near 0, so the last bits of f32 rounding decide
a few huge per-pixel terms, which then dominate gradients whose other terms
cancel (a sphere translation brightens one side and darkens the other).

This module removes both effects: it takes the hit topology the kernel
recorded (its residual planes), restricts the L2 cotangent to pixels whose
topology is constant over their 3x3 neighborhood
(``gradcheck.stable_topology_mask``), and differentiates the XLA replay
(``kernels/adjoint.py::replay_render``) in float64 through that same
topology.  The kernel's gradients for the same cotangent must match it to
float32 accuracy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..kernels.adjoint import replay_render
from ..kernels.adjoint_fused import (grads_to_fitparams,
                                     recompute_grads_pallas,
                                     twophase_loss_grads_pallas)
from ..kernels.render_pallas import render_forward_with_residuals
from ..ops.rays import Camera, screen_points
from .gradcheck import stable_topology_mask


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: (jnp.asarray(x, jnp.float64)
                   if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
                   else x), tree)


def masked_grads_vs_replay64(params, scene, camera: Camera,
                             config: RenderConfig, target, *,
                             kernel: str = "twophase",
                             interpret: Optional[bool] = None, pts=None):
    """One single-sample render through ``pts`` (default: the camera's own
    screen points).  Returns ``(g_kernel, g_64, stable_share)``: the
    ``FitParams`` gradients of the stable-pixel L2 loss
    ``sum(mask * (img - target)^2) / (H*W*3)`` from a kernel backward
    (``kernel="twophase"``: cotangent formed in-kernel from the mask;
    ``"recompute"``: the supersampled fit's per-sample kernel, cotangent
    passed in) and from the float64 replay VJP, plus the share of pixels
    the mask keeps."""
    cfg1 = dataclasses.replace(config, samples=1, force_jitter=False,
                               adaptive=False)
    h, w = cfg1.height, cfg1.width
    if pts is None:
        pts = screen_points(camera, w, h)
    scene_p = params.into_scene(scene)
    img, res = render_forward_with_residuals(scene_p, camera, cfg1,
                                             interpret=interpret, pts=pts)
    res = {k: np.asarray(v) for k, v in res.items()}
    mask = stable_topology_mask(res).astype(np.float32)
    denom = float(h * w * 3)
    target = jnp.asarray(target, jnp.float32)
    g = (2.0 / denom) * (img - target) * mask[..., None]
    if kernel == "twophase":
        _, grads_c = twophase_loss_grads_pallas(
            scene_p, camera, cfg1, target, mask=mask, denom=denom,
            interpret=interpret, pts=pts)
    else:
        grads_c = recompute_grads_pallas(scene_p, camera, cfg1, g,
                                         interpret=interpret, pts=pts)
    g_kernel = grads_to_fitparams(params, scene_p, grads_c)
    with jax.enable_x64(True):
        params64, scene64, camera64 = _f64((params, scene, camera))
        _, pull = jax.vjp(lambda p: replay_render(
            p.into_scene(scene64), camera64, cfg1, _f64(res),
            pts=jnp.asarray(pts, jnp.float64)), params64)
        g_64 = jax.tree_util.tree_map(
            np.asarray, pull(jnp.asarray(np.asarray(g), jnp.float64))[0])
    return g_kernel, g_64, float(mask.mean())
