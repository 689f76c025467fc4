"""The kernel backward kernels vs the float64 replay through the kernel's
own hit topology on stable pixels (oracle/replay64.py) — the comparison
chip_smoke.py gates on the card, here with the kernels in interpret mode."""
import numpy as np
import pytest

from ray_tracer_fragment_shader_tpu.diff.fit import FitParams
from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
    render_image_pallas)
from ray_tracer_fragment_shader_tpu.ops.rays import Camera, sample_jitter, \
    screen_points
from ray_tracer_fragment_shader_tpu.oracle.replay64 import (
    masked_grads_vs_replay64)
from ray_tracer_fragment_shader_tpu.scene import presets

SIZE = 32
FIELDS = ["sph_center", "sph_radius", "light_pos", "mat_diffuse",
          "mat_specular", "mat_ambient"]


@pytest.mark.parametrize("kernel", ["twophase", "recompute"])
def test_kernel_grads_match_float64_replay(kernel):
    import jax
    scene, camcfg, cfg = presets.full_reflective(size=SIZE, depth=2)
    cam = Camera.from_config(camcfg, SIZE, SIZE)
    target = render_image_pallas(scene, cam, cfg, interpret=True) * 0.9
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 0.4)
    pts = None
    if kernel == "recompute":     # a jittered sample, as the supersampled
        pts0 = screen_points(cam, SIZE, SIZE)       # fit renders them
        pts = pts0 + sample_jitter(jax.random.PRNGKey(3), pts0.shape[0],
                                   cfg.jitter_scale)
    g_k, g_64, share = masked_grads_vs_replay64(
        params, scene, cam, cfg, target, kernel=kernel, interpret=True,
        pts=pts)
    assert 0.3 < share < 1.0
    for f in FIELDS:
        a = np.asarray(getattr(g_k, f), np.float64)
        b = getattr(g_64, f)
        assert b.dtype == np.float64
        r = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert r < 5e-4, f"{f}: rel diff {r:.3g}"
        assert np.abs(b).max() > 0
