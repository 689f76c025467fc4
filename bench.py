"""One-cell benchmark: primary rays/s of the forward+backward fit step (or the
forward alone) on the full reflective scene at 1024^2 with depth-3
reflections (BASELINE config 3), on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "rays/s", ...}
after a line with the card's name and power limit.  Exits non-zero when JAX
finds no GPU.

Ray accounting: primary rays only (``size*size*samples``); shadow and
bounce rays are per-ray work, not the ray count.  The step time is the
median of ``BENCH_ITERS`` calls after warm-up, each ended by
``block_until_ready`` (utils/timing.py).

Environment: BENCH_SIZE (1024), BENCH_DEPTH (3), BENCH_ITERS (20),
BENCH_FORWARD_ONLY (0), BENCH_BACKEND (``pallas`` = the kernels, ``xla`` =
the core renderer under ``jax.grad``), BENCH_PRESET (``full_reflective`` or
``procedural_spheres``, BASELINE config 5).
"""
from __future__ import annotations

import json
import os
import sys

import jax


def main() -> int:
    from ray_tracer_fragment_shader_tpu.utils.cache import (
        enable_compile_cache)
    from ray_tracer_fragment_shader_tpu.utils.timing import (
        gpu_name_and_power_limit, median_time, require_gpu)
    try:
        devices = require_gpu()
    except RuntimeError as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = gpu_name_and_power_limit()
    print(f"# card: {card}")

    size = int(os.environ.get("BENCH_SIZE", "1024"))
    depth = int(os.environ.get("BENCH_DEPTH", "3"))
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    forward_only = os.environ.get("BENCH_FORWARD_ONLY", "0") == "1"
    backend = os.environ.get("BENCH_BACKEND", "pallas")
    preset = os.environ.get("BENCH_PRESET", "full_reflective")

    from ray_tracer_fragment_shader_tpu.core.renderer import render_image
    from ray_tracer_fragment_shader_tpu.diff.fit import (FitParams, l2_loss)
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        fit_value_and_grad, prepare_fit_inputs)
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_image_pallas)
    from ray_tracer_fragment_shader_tpu.ops.rays import Camera
    from ray_tracer_fragment_shader_tpu.scene import presets

    make = (presets.procedural_spheres if preset == "procedural_spheres"
            else presets.full_reflective)
    scene, camcfg, config = make(size=size, depth=depth)
    camera = Camera.from_config(camcfg, config.width, config.height)
    params = FitParams.from_scene(scene)

    if forward_only:
        render = render_image_pallas if backend == "pallas" else render_image
        step = jax.jit(lambda s: render(s, camera, config))
        args = (scene,)
    else:
        target = jax.block_until_ready(
            jax.jit(lambda s: render_image(s, camera, config))(scene))
        if backend == "pallas":
            prep = prepare_fit_inputs(camera, config, target)
            step = jax.jit(lambda p: fit_value_and_grad(
                p, scene, camera, config, target, prep=prep))
        else:
            step = jax.jit(lambda p: jax.value_and_grad(l2_loss)(
                p, scene, camera, config, target))
        args = (params,)

    with jax.default_matmul_precision("highest"):
        timing = median_time(lambda: step(*args), iters=iters)
    dt = timing["median_s"]
    rays = size * size * config.samples
    tag = "" if preset == "full_reflective" else f"_{preset}"
    out = {
        "metric": f"rays_per_s_{'fwd' if forward_only else 'fwd_bwd'}"
                  f"_{size}x{size}_depth{depth}{tag}",
        "value": rays / dt,
        "unit": "rays/s",
        "ray_accounting": "primary rays only (size*size*samples)",
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "card": card,
        "backend": backend,
        "step_time_ms": dt * 1e3,
        "step_time_ms_min_max": [timing["min_s"] * 1e3,
                                 timing["max_s"] * 1e3],
        "iters": iters,
        "warmup_s": timing["warmup_s"],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
