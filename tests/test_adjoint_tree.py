"""Fractional-transparency scenes (the bounce tree): their gradients come
from XLA autodiff of the core tree renderer, and every kernel-path entry
point (``l2_loss_pallas``, ``fit_value_and_grad``, ``render_image_pallas``)
routes such scenes there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracer_fragment_shader_tpu.config import RenderConfig
from ray_tracer_fragment_shader_tpu.core.renderer import render_image
from ray_tracer_fragment_shader_tpu.diff.fit import FitParams, l2_loss
from ray_tracer_fragment_shader_tpu.kernels.adjoint import l2_loss_pallas
from ray_tracer_fragment_shader_tpu.ops.rays import Camera
from ray_tracer_fragment_shader_tpu.scene import Material, SceneBuilder
from ray_tracer_fragment_shader_tpu.scene.presets import _cam

SIZE = 32


def _scene():
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(0.5, 0.5, 0.5),
                     refraction=0.9)
    scene = (SceneBuilder()
             .add_checkerboard()
             .add_sphere("d5", material=glass)
             .add_sphere("c3")
             .add_light("b6")
             .build())
    assert not scene.chain_exact
    return scene


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


@pytest.fixture(scope="module")
def setup():
    scene = _scene()
    cfg = RenderConfig(width=SIZE, height=SIZE, max_depth=2, samples=1)
    camcfg = _cam(SIZE)
    cam = Camera.from_config(camcfg, SIZE, SIZE)
    return scene, cam, cfg


def test_tree_grads_match_core_autodiff(setup):
    """On a tree scene the kernel-path loss is the XLA tree loss: its
    value and gradients equal jax.value_and_grad of diff.fit.l2_loss."""
    scene, cam, cfg = setup
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 0.6)
    target = render_image(scene, cam, cfg)

    loss_p, g_p = jax.value_and_grad(l2_loss_pallas)(params, scene, cam,
                                                     cfg, target)
    loss_c, g_c = jax.value_and_grad(l2_loss)(params, scene, cam, cfg,
                                              target)
    assert float(loss_p) == float(loss_c)
    for fname in ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
                  "mat_specular", "mat_ambient"):
        np.testing.assert_array_equal(np.asarray(getattr(g_p, fname)),
                                      np.asarray(getattr(g_c, fname)))
        assert np.abs(np.asarray(getattr(g_c, fname))).max() > 0


def test_tree_l2_fit_descends(setup):
    """End-to-end: Adam on the tree-scene L2 loss through the kernel-path
    entry points reduces it.  Perturbs material diffuse — a smooth,
    near-quadratic direction of the loss — so descent is deterministic
    (geometry directions of mirror/glass scenes are rugged; see
    diff/multiview.py for the robust geometry recipe)."""
    import optax
    scene, cam, cfg = setup
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_image_pallas)
    target = render_image_pallas(scene, cam, cfg)
    params = FitParams.from_scene(scene).replace(
        mat_diffuse=scene.mat_diffuse * 1.6 + 0.05)
    opt = optax.adam(0.02)
    state = opt.init(params)
    losses = []
    for _ in range(8):
        loss, grads = jax.value_and_grad(l2_loss_pallas)(
            params, scene, cam, cfg, target)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0]
    assert np.isfinite(losses).all()


def test_fused_tree_adjoint_matches_xla_replay(setup):
    """fit_value_and_grad on a fractional-transparency scene takes the XLA
    tree route and equals jax.value_and_grad of the kernel-path loss."""
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        fit_value_and_grad)
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_image_pallas)
    scene, cam, cfg = setup
    target = render_image_pallas(scene, cam, cfg)
    params = FitParams.from_scene(scene).replace(
        mat_diffuse=scene.mat_diffuse * 1.3 + 0.02,
        sph_center=scene.sph_center + 0.6)

    loss_f, g_f = fit_value_and_grad(params, scene, cam, cfg, target)
    loss_x, g_x = jax.value_and_grad(l2_loss_pallas)(
        params, scene, cam, cfg, target)

    np.testing.assert_allclose(float(loss_f), float(loss_x), rtol=1e-6)
    for fname in ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
                  "mat_specular", "mat_ambient"):
        r = _rel(getattr(g_x, fname), getattr(g_f, fname))
        assert r < 1e-6, f"{fname}: rel diff {r:.3g}"
        assert np.abs(np.asarray(getattr(g_f, fname))).max() > 0


def test_fused_tree_adjoint_supersampled_matches_core(setup):
    """Supersampled fractional-transparency fit through fit_value_and_grad
    matches jax.grad of the supersampled core tree loss (same jitter PRNG
    stream; the tolerances are those of the chain kernel test in
    test_pallas_features.py)."""
    import dataclasses

    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        fit_value_and_grad)
    scene, cam, cfg = setup
    cfg_s = dataclasses.replace(cfg, samples=2)
    target = render_image(scene, cam, cfg_s) * 0.9  # nonzero cotangent
    params = FitParams.from_scene(scene)

    loss_f, g_f = fit_value_and_grad(params, scene, cam, cfg_s, target)
    loss_c, g_c = jax.value_and_grad(l2_loss)(params, scene, cam, cfg_s,
                                              target)
    assert float(loss_f) == pytest.approx(float(loss_c), rel=5e-3)
    for fname, tol in [("sph_center", 1e-2), ("mat_diffuse", 3e-2),
                       ("light_pos", 3e-2)]:
        r = _rel(getattr(g_c, fname), getattr(g_f, fname))
        assert r < tol, f"{fname}: rel diff {r:.3g}"
