"""Inverse-rendering demo artifact (ROADMAP r2->3 item 7).

Runs the robust multi-view config-4 recipe (diff/multiview.py) end to end:
perturb the fit_target scene (sphere centers/radii + light), recover it from
3 orbit-view hard renders, and commit the evidence —

    artifacts/fit_demo/before.png    base view, perturbed init
    artifacts/fit_demo/target.png    base view, ground truth
    artifacts/fit_demo/after.png     base view, recovered parameters
    artifacts/fit_demo/triptych.png  the three side by side
    artifacts/fit_demo/recovery.json init/final recovery errors, stage log

The reference has no inverse story at all (forward-only CPU renderer,
Hw4/MySdlApplication.cpp:1184-1324); this is the "differentiable" half of
the north star demonstrated as a repo artifact.

Usage:  python scripts/make_fit_demo.py [--size 256] [--seed 3]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ray_tracer_fragment_shader_tpu.diff.fit import FitParams  # noqa: E402
from ray_tracer_fragment_shader_tpu.diff.multiview import (  # noqa: E402
    fit_multiview, multiview_loss, orbit_views, recovery_report, render_views)
from ray_tracer_fragment_shader_tpu.io.image import write_png  # noqa: E402
from ray_tracer_fragment_shader_tpu.ops.rays import Camera  # noqa: E402
from ray_tracer_fragment_shader_tpu.scene import presets  # noqa: E402
from ray_tracer_fragment_shader_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256,
                    help="full-resolution stage (BASELINE config 4 is 512; "
                         "256 keeps the committed artifact small)")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--views", type=int, default=3)
    ap.add_argument("--out", default="artifacts/fit_demo")
    args = ap.parse_args()
    enable_compile_cache()

    scene, camcfg, cfg = presets.fit_target(size=args.size)
    views = orbit_views(camcfg, args.views, span_deg=80.0)
    cams = [Camera.from_config(v, args.size, args.size) for v in views]
    t0 = time.time()
    targets = render_views(scene, views, cfg)
    jax.block_until_ready(targets)

    # --- documented perturbation: the problem the fit has to solve ---
    rng = np.random.RandomState(args.seed)
    nv = int(np.asarray(scene.sph_valid).sum())
    dc = np.zeros((scene.num_spheres, 3), np.float32)
    dc[:nv] = rng.uniform(-8, 8, (nv, 3))
    dl = rng.uniform(-10, 10, np.asarray(scene.light_pos).shape
                     ).astype(np.float32)
    init = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + jnp.asarray(dc),
        sph_radius=scene.sph_radius * jnp.asarray(
            1 + rng.uniform(-0.1, 0.1, scene.num_spheres), jnp.float32),
        light_pos=scene.light_pos + jnp.asarray(dl))
    err0 = recovery_report(init, scene)

    res = fit_multiview(scene, views, cfg, targets, init=init,
                        sizes=(64, 128), sigmas=(1.5, 1.0, None),
                        steps_per_sigma=60, restarts=4, restart_steps=40,
                        geom_lr=0.6, light_lr=1.0, seed=args.seed)
    err1 = recovery_report(res.params, scene)
    fit_s = time.time() - t0

    l_init = float(multiview_loss(init, scene, cams, cfg, targets, None))
    l_fit = float(multiview_loss(res.params, scene, cams, cfg, targets,
                                 None))

    os.makedirs(args.out, exist_ok=True)
    target_img = np.asarray(targets[0])
    before = np.asarray(render_views(init.into_scene(scene), views[:1],
                                     cfg))[0]
    after = np.asarray(render_views(res.params.into_scene(scene), views[:1],
                                    cfg))[0]
    write_png(os.path.join(args.out, "before.png"), before)
    write_png(os.path.join(args.out, "target.png"), target_img)
    write_png(os.path.join(args.out, "after.png"), after)
    gap = np.ones((args.size, 4, 3), np.float32)
    write_png(os.path.join(args.out, "triptych.png"),
              np.concatenate([before, gap, target_img, gap, after], 1))

    report = dict(
        size=args.size, views=args.views, seed=args.seed,
        device=dict(platform=jax.devices()[0].platform,
                    kind=jax.devices()[0].device_kind),
        board_square_world_units=40.0,
        init_errors=err0, final_errors=err1,
        loss_init=l_init, loss_fit=l_fit,
        restart_losses=res.restart_losses,
        stage_log=res.stage_log, fit_wall_s=round(fit_s, 1))
    with open(os.path.join(args.out, "recovery.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(dict(center_err=(err0["center_err_max"],
                                      err1["center_err_max"]),
                          light_err=(err0["light_err_max"],
                                     err1["light_err_max"]),
                          loss=(l_init, l_fit), wall_s=round(fit_s, 1))))


if __name__ == "__main__":
    main()
