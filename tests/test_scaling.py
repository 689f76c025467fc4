"""Scaling sweep harness: structural validation on the virtual CPU mesh."""
import dataclasses

import numpy as np

from ray_tracer_fragment_shader_tpu.ops.rays import Camera
from ray_tracer_fragment_shader_tpu.parallel.multihost import scaling_sweep
from ray_tracer_fragment_shader_tpu.scene import presets


def test_scaling_sweep_structure(eight_devices):
    scene, camcfg, cfg = presets.fit_target(size=16)
    cfg = dataclasses.replace(cfg, chunk_size=512)
    cam = Camera.from_config(camcfg, 16, 16)
    rows = scaling_sweep(scene, cam, cfg, mesh_sizes=[1, 2, 4], iters=2,
                         backend="core")
    assert [r["n"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["step_time_s"] > 0
        assert np.isfinite(r["loss"])
        assert r["efficiency"] > 0
    # same loss on every mesh size (same global computation)
    losses = [r["loss"] for r in rows]
    assert max(losses) - min(losses) < 1e-4


def test_scaling_sweep_pallas_fast_path(eight_devices):
    """The default sweep exercises the kernel path: per-band two-phase
    Pallas kernels (interpret mode here), psum'd grads."""
    scene, camcfg, cfg = presets.fit_target(size=16)
    cam = Camera.from_config(camcfg, 16, 16)
    rows = scaling_sweep(scene, cam, cfg, mesh_sizes=[1, 2, 4], iters=2,
                         interpret=True)
    assert [r["n"] for r in rows] == [1, 2, 4]
    losses = [r["loss"] for r in rows]
    assert np.isfinite(losses).all()
    assert max(losses) - min(losses) < 1e-4
