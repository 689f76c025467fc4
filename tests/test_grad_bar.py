"""BASELINE gradient bar: grad max-abs-err <= 1e-4 vs an independent f64
reference (BASELINE.md "gradient accuracy vs NumPy/CPU reference").

Ground truth: central finite differences through the float64 NumPy oracle,
via the shared harness oracle/gradcheck.py (stable-interior-pixel
selection, O(1)-scaled functional — see its docstring for the
fixed-topology convention).  Candidates:

  * the in-kernel adjoint on the chain scene (recompute backward kernel);
  * XLA autodiff of the core tree renderer on a fractional-transparency
    scene with TWO lights (the route that serves tree scenes);
  * camera-eye gradients through the XLA replay vjp
    (kernels/adjoint.py::render_image_diff).

These run the kernels in interpret mode.  ``chip_smoke.py`` runs the same
harness on the compiled kernels on the GPU, held to the same 1e-4 bar.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracer_fragment_shader_tpu.core.renderer import render_image
from ray_tracer_fragment_shader_tpu.diff.fit import FitParams
from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
    recompute_grads_pallas)
from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
    compact_scene, render_forward_with_residuals)
from ray_tracer_fragment_shader_tpu.ops.rays import Camera
from ray_tracer_fragment_shader_tpu.oracle.gradcheck import (
    fd_eye, make_functional, run_grad_bar, stable_interior_pixels,
    stratified_pick, summarize)
from ray_tracer_fragment_shader_tpu.scene import Material, SceneBuilder
from ray_tracer_fragment_shader_tpu.scene import presets

SIZE = 128
BAR = 1e-4  # BASELINE.json: grad max-abs-err vs reference


def _check(s):
    # the bar is meaningful only if the gradients aren't all ~0
    assert s["grad_scale"] > 1e-3, "degenerate test: all-zero gradients"
    assert s["max_abs_err"] <= BAR, (
        f"max-abs-err {s['max_abs_err']:.3e} > {BAR} at {s['worst']} "
        f"(candidate {s['worst_candidate']:.6e}, fd {s['worst_fd']:.6e}); "
        f"|grad|_max={s['grad_scale']:.3e}")


def test_fused_adjoint_grad_max_abs_err_le_1e4_vs_f64_oracle_fd():
    """Chain scene, in-kernel adjoint (recompute backward kernel)."""
    scene, camcfg, cfg = presets.fit_target(size=SIZE)

    def grads_fn(cam, g):
        return recompute_grads_pallas(compact_scene(scene), cam, cfg, g,
                                      interpret=True)

    _check(run_grad_bar(scene, camcfg, cfg, grads_fn, interpret=True))


def _tree_scene_two_lights():
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(0.5, 0.5, 0.5),
                     refraction=0.9)
    scene = (SceneBuilder()
             .add_checkerboard()
             .add_sphere("d5", material=glass)
             .add_sphere("c3")
             .add_light("b6")
             .add_light("f7", color=(0.8, 0.9, 1.0))
             .build())
    assert not scene.chain_exact
    assert scene.num_lights == 2
    return scene


def test_tree_adjoint_grad_bar_two_lights():
    """Fractional-transparency scene (bounce TREE), 2 lights: XLA autodiff
    of the core tree renderer vs f64-oracle FD, same 1e-4 bar.  The
    oracle's trace_ray is the literal recursive rayTraceRay (both
    branches), so it is tree ground truth."""
    scene = compact_scene(_tree_scene_two_lights())
    camcfg = presets._cam(64)
    cfg = dataclasses.replace(
        presets.fit_target(size=64)[2], width=64, height=64, max_depth=2)

    def grads_fn(cam, g):
        params = FitParams.from_scene(scene)
        _, vjp = jax.vjp(
            lambda p: render_image(p.into_scene(scene), cam, cfg), params)
        (gp,) = vjp(g)
        return dict(sph_center=gp.sph_center, sph_radius=gp.sph_radius,
                    light_pos=gp.light_pos, mat_ambient=gp.mat_ambient,
                    mat_diffuse=gp.mat_diffuse,
                    mat_specular=gp.mat_specular)

    _check(run_grad_bar(scene, camcfg, cfg, grads_fn, interpret=True,
                        n_each=8, min_sph=2))


def test_camera_eye_grad_bar():
    """Camera gradients through the XLA replay vjp (render_image_diff) vs
    FD through the oracle with the basis recomputed — the same chain the
    autodiff takes through Camera.eye -> basis() -> screen points."""
    from ray_tracer_fragment_shader_tpu.kernels.adjoint import (
        render_image_diff)
    scene, camcfg, cfg = presets.fit_target(size=64)
    scene = compact_scene(scene)
    cam = Camera.from_config(camcfg, cfg.width, cfg.height, dtype=jnp.float32)
    img, res = render_forward_with_residuals(scene, cam, cfg,
                                             interpret=True)
    pix = stable_interior_pixels(res, cfg, scene, camcfg)
    pix, _ = stratified_pick(pix, res, scene, n_each=8)
    rng = np.random.RandomState(1)
    w_rgb = rng.uniform(0.25, 1.0, size=(len(pix), 3))
    jj = jnp.asarray([p[0] for p in pix])
    ii = jnp.asarray([p[1] for p in pix])
    w = jnp.asarray(w_rgb, jnp.float32)

    def img_J(camera):
        img = render_image_diff(scene, camera, cfg, True)
        return jnp.sum(w * img[jj, ii]) / len(pix)

    g_cam = jax.grad(img_J)(cam)
    J = make_functional(scene, cfg, camcfg, pix, w_rgb)
    checks = [(f"eye[{a}]", float(np.asarray(g_cam.eye)[a]),
               fd_eye(J, a, 1e-3)) for a in range(3)]
    s = summarize(checks)
    assert s["grad_scale"] > 1e-4, "degenerate: zero camera gradient"
    assert s["max_abs_err"] <= BAR, (
        f"camera grad max-abs-err {s['max_abs_err']:.3e} > {BAR} at "
        f"{s['worst']} (candidate {s['worst_candidate']:.6e}, "
        f"fd {s['worst_fd']:.6e})")
