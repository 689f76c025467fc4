"""The multi-device kernel path: per row-band shard, the two-phase Pallas
kernels (forward + in-kernel adjoint), FitParams grads psum'd over the
mesh.  Runs on the 8-virtual-device CPU mesh with the kernels in interpret
mode — the same shard_map/Mesh code that runs on several GPUs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tracer_fragment_shader_tpu.diff.fit import (
    FitParams, make_sharded_fit_step, make_sharded_fit_step_pallas)
from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
    fit_value_and_grad)
from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
    render_image_pallas)
from ray_tracer_fragment_shader_tpu.ops.rays import Camera
from ray_tracer_fragment_shader_tpu.parallel.mesh import make_mesh
from ray_tracer_fragment_shader_tpu.parallel.shard import render_image_sharded
from ray_tracer_fragment_shader_tpu.scene import presets

SIZE = 32
BLOCKS = dict(interpret=True)


def test_sharded_pallas_forward_matches_single_device(eight_devices):
    scene, camcfg, cfg = presets.full_reflective(size=SIZE, depth=2)
    cam = Camera.from_config(camcfg, cfg.width, cfg.height)
    mesh = make_mesh(eight_devices)
    sharded = np.asarray(render_image_sharded(scene, cam, cfg, mesh,
                                              backend="pallas", **BLOCKS))
    single = np.asarray(render_image_pallas(scene, cam, cfg, **BLOCKS))
    np.testing.assert_allclose(sharded, single, atol=1e-5)


def test_sharded_pallas_forward_row_padding(eight_devices):
    """Height not divisible by the mesh: 20 rows over 8 shards."""
    scene, camcfg, cfg = presets.three_spheres_ground(size=SIZE)
    cfg = dataclasses.replace(cfg, width=24, height=20)
    cam = Camera.from_config(camcfg, 24, 20)
    mesh = make_mesh(eight_devices)
    sharded = np.asarray(render_image_sharded(scene, cam, cfg, mesh,
                                              backend="pallas", **BLOCKS))
    single = np.asarray(render_image_pallas(scene, cam, cfg, **BLOCKS))
    np.testing.assert_allclose(sharded, single, atol=1e-5)
    assert sharded.shape == (20, 24, 3)


def test_sharded_pallas_fit_step_matches_fused_single_device(eight_devices):
    """One sharded fast-path step == one single-device fused step: identical
    loss, identical updated params (up to tile-order float reassociation)."""
    scene, camcfg, cfg = presets.fit_target(size=SIZE)
    cam = Camera.from_config(camcfg, cfg.width, cfg.height)
    target = render_image_pallas(scene, cam, cfg, **BLOCKS)

    params0 = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 2.0,
        sph_radius=scene.sph_radius * 1.1)
    opt = optax.adam(0.1)

    # single-device fused reference step
    loss_s, grads_s = fit_value_and_grad(params0, scene, cam, cfg, target,
                                         **BLOCKS)
    opt_state = opt.init(params0)
    updates, _ = opt.update(grads_s, opt_state, params0)
    params_s = optax.apply_updates(params0, updates)

    mesh = make_mesh(eight_devices)
    step, tgt = make_sharded_fit_step_pallas(scene, cam, cfg, target, opt,
                                             mesh, **BLOCKS)
    opt_state = opt.init(params0)
    params_m, _, loss_m = step(params0, opt_state, tgt)

    assert float(loss_m) == pytest.approx(float(loss_s), rel=1e-5)
    for leaf_s, leaf_m in zip(jax.tree_util.tree_leaves(params_s),
                              jax.tree_util.tree_leaves(params_m)):
        np.testing.assert_allclose(np.asarray(leaf_m), np.asarray(leaf_s),
                                   rtol=2e-4, atol=2e-6)


def test_sharded_pallas_fit_descends(eight_devices):
    scene, camcfg, cfg = presets.fit_target(size=SIZE)
    cam = Camera.from_config(camcfg, cfg.width, cfg.height)
    mesh = make_mesh(eight_devices)
    target = render_image_sharded(scene, cam, cfg, mesh, backend="pallas",
                                  **BLOCKS)
    opt = optax.adam(0.1)
    step, tgt = make_sharded_fit_step_pallas(scene, cam, cfg, target, opt,
                                             mesh, **BLOCKS)
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 2.0)
    opt_state = opt.init(params)
    losses = []
    for _ in range(8):
        params, opt_state, loss = step(params, opt_state, tgt)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_sharded_pallas_fit_step_tree_scene(eight_devices):
    """Fractional-transparency scenes need the bounce tree, which has no
    kernel: the sharded kernel step refuses them, and the sharded XLA step
    (``make_sharded_fit_step``, core renderer under autodiff, psum'd
    grads) on the 8-device mesh matches the same step on one device."""
    from ray_tracer_fragment_shader_tpu.scene import Material, SceneBuilder

    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(0.5, 0.5, 0.5),
                     refraction=0.9)
    scene = (SceneBuilder().add_checkerboard()
             .add_sphere("d5", material=glass).add_sphere("c3")
             .add_light("b6").build())
    assert not scene.chain_exact
    camcfg = presets._cam(SIZE)
    cfg = dataclasses.replace(presets.fit_target(size=SIZE)[2], max_depth=2)
    cam = Camera.from_config(camcfg, cfg.width, cfg.height)
    target = render_image_pallas(scene, cam, cfg)
    tgt_flat = jnp.reshape(target, (-1, 3))

    params0 = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 1.0)
    opt = optax.adam(0.05)
    with pytest.raises(ValueError, match="make_sharded_fit_step"):
        make_sharded_fit_step_pallas(scene, cam, cfg, target, opt,
                                     make_mesh(eight_devices), **BLOCKS)

    results = []
    for devices in (eight_devices[:1], eight_devices):
        step, (ii, jj) = make_sharded_fit_step(scene, cam, cfg, tgt_flat,
                                               opt, make_mesh(devices))
        results.append(step(params0, opt.init(params0), ii, jj, tgt_flat))
    (params_s, _, loss_s), (params_m, _, loss_m) = results

    assert float(loss_m) == pytest.approx(float(loss_s), rel=1e-5)
    for leaf_s, leaf_m in zip(jax.tree_util.tree_leaves(params_s),
                              jax.tree_util.tree_leaves(params_m)):
        np.testing.assert_allclose(np.asarray(leaf_m), np.asarray(leaf_s),
                                   rtol=2e-4, atol=2e-6)
