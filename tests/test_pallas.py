"""Pallas forward kernel (Triton route) parity vs the core renderer, with the
kernel in the Pallas interpreter on the CPU."""
import dataclasses

import numpy as np
import pytest

from ray_tracer_fragment_shader_tpu.core.renderer import render_image
from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
    pack_scene, render_image_pallas)
from ray_tracer_fragment_shader_tpu.scene import presets

SIZE = 32


def _compare(name, frac_budget=0.01, **kwargs):
    scene, cam, cfg = presets.PRESETS[name](size=SIZE, **kwargs)
    a = np.asarray(render_image(scene, cam, cfg))
    b = np.asarray(render_image_pallas(scene, cam, cfg,
                                       interpret=True))
    d = np.abs(a - b).max(-1)
    # budget for decision-boundary pixels (horizon-row checker parity etc.)
    assert (d > 1e-3).mean() <= frac_budget, (
        f"{name}: {(d > 1e-3).mean():.4f} mismatching, max {d.max():.3g}")
    assert a.mean() == pytest.approx(b.mean(), rel=0.05)


def test_single_sphere():
    _compare("single_sphere", frac_budget=0.0)


def test_three_spheres_shadows():
    _compare("three_spheres_ground")


def test_full_reflective_bounces():
    _compare("full_reflective")


def test_reference_demo_transmission_chain():
    scene, cam, cfg = presets.reference_demo()
    cfg = dataclasses.replace(cfg, width=SIZE, height=SIZE, samples=1,
                              max_depth=3)
    a = np.asarray(render_image(scene, cam, cfg))
    b = np.asarray(render_image_pallas(scene, cam, cfg,
                                       interpret=True))
    d = np.abs(a - b).max(-1)
    # the demo's 1:1 pixel scale puts a whole image row on the board-plane
    # horizon where checker parity is decision-boundary noise
    assert (d > 1e-3).mean() <= 0.02


def test_nonsquare_padding():
    scene, cam, cfg = presets.single_sphere(size=SIZE)
    cfg = dataclasses.replace(cfg, width=48, height=24)
    a = np.asarray(render_image(scene, cam, cfg))
    b = np.asarray(render_image_pallas(scene, cam, cfg,
                                       interpret=True))
    assert b.shape == (24, 48, 3)
    assert np.abs(a - b).max() < 1e-3


def test_supersampling_matches_core():
    scene, cam, cfg = presets.single_sphere(size=16)
    cfg = dataclasses.replace(cfg, samples=4)
    a = np.asarray(render_image(scene, cam, cfg))
    b = np.asarray(render_image_pallas(scene, cam, cfg,
                                       interpret=True))
    # same PRNG keys and jitter distribution -> identical sample sets
    np.testing.assert_allclose(a, b, atol=1e-3)


def _fractional_scene():
    """Fractional transparency (T=0.5): the reference's rayTraceRay traces
    BOTH a transmitted child weighted T and a reflected child weighted 1-T
    (MySdlApplication.cpp:1238-1246) — the bounce tree, not a chain."""
    from ray_tracer_fragment_shader_tpu.scene import Material, SceneBuilder
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


def test_fractional_scene_renders_through_xla_tree():
    """A fractional-T scene needs the bounce tree, which has no kernel: the
    kernel entry point hands it to the XLA tree renderer, so the two
    entry points agree exactly (and no interpret flag is needed)."""
    from ray_tracer_fragment_shader_tpu.config import RenderConfig
    from ray_tracer_fragment_shader_tpu.scene.presets import _cam
    scene = _fractional_scene()
    cfg = RenderConfig(width=SIZE, height=SIZE, max_depth=2, samples=1)
    cam = _cam(SIZE)
    a = np.asarray(render_image(scene, cam, cfg))  # auto-routes to tree mode
    b = np.asarray(render_image_pallas(scene, cam, cfg))
    np.testing.assert_array_equal(a, b)


def test_residual_forward_matches_plain_forward():
    """The residual-emitting forward renders the same image as the plain
    kernel, with one residual plane per bounce level, and refuses scenes
    that need the bounce tree."""
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_forward_with_residuals)
    from ray_tracer_fragment_shader_tpu.ops.rays import Camera
    scene, camcfg, cfg = presets.three_spheres_ground(size=16)
    cam = Camera.from_config(camcfg, 16, 16)
    img, res = render_forward_with_residuals(scene, cam, cfg, interpret=True)
    plain = render_image_pallas(scene, cam, cfg, interpret=True)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(plain))
    assert res["bi"].shape == (cfg.max_depth + 1, 16, 16)
    assert res["lit"].shape == (scene.num_lights, cfg.max_depth + 1, 16, 16)
    with pytest.raises(ValueError, match="tree"):
        render_forward_with_residuals(_fractional_scene(), cam, cfg,
                                      interpret=True)


def test_procedural_spheres_full_count_256():
    """BASELINE config 5 at its full primitive count (n=64 spheres, 2
    lights, depth 3) at 256^2 — pallas kernel vs core renderer (VERDICT r1
    item 4's CPU coverage; the card runs it with
    BENCH_PRESET=procedural_spheres)."""
    scene, camcfg, cfg = presets.procedural_spheres(n=64, size=256, depth=3)
    from ray_tracer_fragment_shader_tpu.ops.rays import Camera
    cam = Camera.from_config(camcfg, 256, 256)
    a = np.asarray(render_image(scene, cam, cfg))
    b = np.asarray(render_image_pallas(scene, cam, cfg,
                                       interpret=True))
    d = np.abs(a - b).max(-1)
    assert (d > 1e-3).mean() <= 0.01, f"{(d > 1e-3).mean():.4f} mismatching"
    assert a.mean() == pytest.approx(b.mean(), rel=0.02)


def test_pack_scene_compacts_padding():
    scene, _, _ = presets.full_reflective(size=16)
    packed = pack_scene(scene)
    assert packed["tri"].shape[0] == int(np.asarray(scene.tri_valid).sum())
    assert packed["sph"].shape[0] == int(np.asarray(scene.sph_valid).sum())
