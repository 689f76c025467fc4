"""Replay-adjoint correctness: forward reproduction and gradient parity
with autodiff of the core renderer (interpreter mode on CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tracer_fragment_shader_tpu.core.renderer import render_image
from ray_tracer_fragment_shader_tpu.diff.fit import FitParams
from ray_tracer_fragment_shader_tpu.kernels.adjoint import (
    l2_loss_pallas, render_image_diff, replay_render)
from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
    render_forward_with_residuals)
from ray_tracer_fragment_shader_tpu.ops.rays import Camera
from ray_tracer_fragment_shader_tpu.scene import presets

SIZE = 32


@pytest.fixture(scope="module")
def setup():
    scene, camcfg, cfg = presets.full_reflective(size=SIZE)
    cam = Camera.from_config(camcfg, SIZE, SIZE)
    return scene, cam, cfg


def test_replay_reproduces_kernel_forward(setup):
    scene, cam, cfg = setup
    img, res = render_forward_with_residuals(scene, cam, cfg,
                                             interpret=True)
    rep = replay_render(scene, cam, cfg, res)
    np.testing.assert_allclose(np.asarray(img), np.asarray(rep), atol=2e-3)


def test_grads_match_core_autodiff(setup):
    """Uniform-cotangent gradients (insensitive to the few decision-boundary
    pixels where kernel and core pick different hits)."""
    scene, cam, cfg = setup
    params = FitParams.from_scene(scene)

    gc = jax.grad(lambda p: jnp.mean(
        render_image(p.into_scene(scene), cam, cfg)))(params)
    gp = jax.grad(lambda p: jnp.mean(
        render_image_diff(p.into_scene(scene), cam, cfg, True)))(params)

    for fname, tol in [("sph_center", 5e-3), ("sph_radius", 5e-3),
                       ("light_pos", 3e-2), ("mat_diffuse", 3e-2),
                       ("mat_specular", 3e-2), ("mat_ambient", 3e-2)]:
        a = np.asarray(getattr(gc, fname))
        b = np.asarray(getattr(gp, fname))
        denom = max(np.abs(a).max(), 1e-12)
        rel = np.abs(a - b).max() / denom
        assert rel < tol, f"{fname}: rel diff {rel:.4g}"
        assert np.abs(a).max() > 0  # gradients actually flow


def test_camera_grads_flow(setup):
    scene, cam, cfg = setup
    g = jax.grad(lambda c: jnp.mean(
        render_image_diff(scene, c, cfg, True)))(cam)
    assert np.isfinite(np.asarray(g.eye)).all()
    assert np.abs(np.asarray(g.eye)).max() > 0


def test_pallas_fit_descends(setup):
    scene, cam, cfg = setup
    target = render_image_diff(scene, cam, cfg, True)
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 2.0)
    opt = optax.adam(0.05)
    state = opt.init(params)
    losses = []
    for _ in range(6):
        loss, grads = jax.value_and_grad(l2_loss_pallas)(
            params, scene, cam, cfg, target, True)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_residual_forward_rejects_multisample(setup):
    scene, cam, cfg = setup
    with pytest.raises(ValueError):
        render_forward_with_residuals(
            scene, cam, dataclasses.replace(cfg, samples=4),
            interpret=True)
