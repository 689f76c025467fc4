"""Generate the golden regression renders committed under tests/goldens/.

Run on CPU (the platform the test suite uses) so the byte-exact assertion in
tests/test_golden.py compares like for like:

    python scripts/make_goldens.py

Regenerate ONLY when a semantics change is intended and documented — the
goldens exist so kernel/perf work can't silently shift pixels (VERDICT r1
item 8).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "tests", "goldens")
SIZE = 64


def specs():
    from ray_tracer_fragment_shader_tpu.scene import presets
    return {
        # the canonical demo scene (initScene placements) with its real
        # sampling config: 16-sample adaptive supersampling, depth 5
        "reference_demo": lambda: _demo(),
        "single_sphere": lambda: presets.single_sphere(size=SIZE),
        "three_spheres_ground": lambda: presets.three_spheres_ground(size=SIZE),
        "full_reflective": lambda: presets.full_reflective(size=SIZE),
        "fit_target": lambda: presets.fit_target(size=SIZE),
        "procedural_spheres": lambda: presets.procedural_spheres(
            n=64, size=SIZE, depth=3),
    }


def _demo():
    import dataclasses

    from ray_tracer_fragment_shader_tpu.scene import presets
    scene, cam, cfg = presets.reference_demo()
    return scene, cam, dataclasses.replace(cfg, width=SIZE, height=SIZE,
                                           adaptive=True)


def render(name):
    from ray_tracer_fragment_shader_tpu.core.renderer import render_image
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_image_pallas)
    from ray_tracer_fragment_shader_tpu.ops.rays import Camera
    scene, camcfg, cfg = specs()[name]()
    cam = Camera.from_config(camcfg, cfg.width, cfg.height)
    core = np.asarray(render_image(scene, cam, cfg))
    pallas = np.asarray(render_image_pallas(scene, cam, cfg,
                                            interpret=True))
    return core, pallas


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in specs():
        core, pallas = render(name)
        np.save(os.path.join(GOLDEN_DIR, f"{name}_core.npy"), core)
        np.save(os.path.join(GOLDEN_DIR, f"{name}_pallas.npy"), pallas)
        print(f"{name}: core mean {core.mean():.5f}, "
              f"pallas mean {pallas.mean():.5f}")


if __name__ == "__main__":
    main()
