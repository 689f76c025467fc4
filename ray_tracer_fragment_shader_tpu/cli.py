"""Command-line interface — the replacement for the reference's
SDL app shell and stdin scene menu.

The reference's user surface was: an interactive stdin loop asking for
object types (a-f) and board coordinates (``initScene2``,
Hw4/MySdlApplication.cpp:1430-1493), then a 500x500 SDL/OpenGL window
repainting the ray trace every frame (``onExecute``/``onRender``,
``:1631-1659``).  Here: ``interactive`` replicates the menu and renders to
an image file; ``render`` is the non-interactive path (``initScene``-style
named presets or a scene spec); ``fit`` runs the differentiable-fit
workload; ``bench`` times a preset.

Usage:
  python -m ray_tracer_fragment_shader_tpu.cli render --preset reference_demo \
      --size 256 --out demo.png
  python -m ray_tracer_fragment_shader_tpu.cli interactive --out scene.png
  python -m ray_tracer_fragment_shader_tpu.cli fit --steps 100 --out-dir /tmp/fit
  python -m ray_tracer_fragment_shader_tpu.cli bench --preset full_reflective
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def _add_common(p):
    p.add_argument("--size", type=int, default=None,
                   help="square image size (preset default if omitted)")
    p.add_argument("--depth", type=int, default=None, help="max bounce depth")
    p.add_argument("--samples", type=int, default=None, help="samples per pixel")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", choices=["auto", "chain", "tree"], default="auto")
    p.add_argument("--no-prune", action="store_true",
                   help="disable bounding-sphere pruning")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--out", default="render.png",
                   help="output image (.png/.ppm/.npy)")


def _platform(args):
    if getattr(args, "cpu", False):
        import jax
        jax.config.update("jax_platforms", "cpu")


def _load_preset(args):
    from .scene import presets
    kwargs = {}
    if args.size:
        kwargs["size"] = args.size
    fn = presets.PRESETS[args.preset]
    if args.preset == "reference_demo":
        kwargs.pop("size", None)
    scene, cam, cfg = fn(**kwargs)
    if args.preset == "reference_demo" and args.size:
        cfg = dataclasses.replace(cfg, width=args.size, height=args.size)
    updates = {"seed": args.seed, "mode": args.mode, "prune": not args.no_prune}
    if args.depth is not None:
        updates["max_depth"] = args.depth
    if args.samples is not None:
        updates["samples"] = args.samples
    return scene, cam, dataclasses.replace(cfg, **updates)


def _render_and_write(scene, cam, cfg, out_path):
    import jax
    from .core.renderer import render_image
    from .io.image import write_image
    from .ops.rays import Camera
    from .utils.profiling import RaysMeter
    camera = Camera.from_config(cam, cfg.width, cfg.height)
    meter = RaysMeter(rays_per_step=cfg.width * cfg.height * cfg.samples)
    img = np.asarray(jax.jit(
        lambda s, c: render_image(s, c, cfg))(scene, camera))
    meter.step()
    write_image(out_path, img)
    print(f"rendered {cfg.width}x{cfg.height} depth={cfg.max_depth} "
          f"samples={cfg.samples} at {meter.rays_per_s_per_chip/1e6:.1f}M "
          f"rays/s/chip (incl. compile) -> {out_path}")


def cmd_render(args):
    _platform(args)
    scene, cam, cfg = _load_preset(args)
    if getattr(args, "watch", False):
        # Progressive preview: re-render at growing resolution, rewriting
        # --out after each pass — the closest headless analogue of the
        # reference's live repaint loop (MySdlApplication.cpp:1631-1659,
        # deviation D6: a headless accelerator host has no display).  The camera's
        # pixel_scale is widened at each preview level so every pass
        # covers the SAME world rectangle (the reference couples FOV to
        # resolution at 1 unit/pixel).
        # one common divisor for both axes (clamped so neither drops below
        # 16 pixels) keeps every preview pass framing the same world
        # rectangle as the final render; consecutive scales that clamp to
        # the same divisor are deduplicated (a 20-px-tall image would
        # otherwise render the full frame four times)
        divisors = []
        for scale in (8, 4, 2, 1):
            d = max(min(scale, cfg.width // 16, cfg.height // 16), 1)
            if not divisors or divisors[-1] != d:
                divisors.append(d)
        for d in divisors:
            w, h = cfg.width // d, cfg.height // d
            cam_s = dataclasses.replace(
                cam, pixel_scale=cam.pixel_scale * cfg.width / w)
            cfg_s = dataclasses.replace(cfg, width=w, height=h)
            _render_and_write(scene, cam_s, cfg_s, args.out)
        return
    _render_and_write(scene, cam, cfg, args.out)


def cmd_interactive(args):
    """The stdin menu of initScene2: type letter + board coordinate, repeat;
    duplicate coordinates overwrite (map<string,int> semantics)."""
    from .scene import MENU_TYPES, SceneBuilder
    _platform(args)
    board_map = {}
    while True:
        print("Please select the type of object to add:")
        print("(a) light, (b) tetrahedron, (c) cube, (d) sphere, "
              "(e) cylinder, (f) cone")
        t = input().strip().lower()
        if len(t) == 1 and "a" <= t <= "f":
            print("Please enter the position: (a1-h8)")
            coord = input().strip().lower()
            if (len(coord) == 2 and "a" <= coord[0] <= "h"
                    and "1" <= coord[1] <= "8"):
                board_map[coord] = ord(t) - ord("a")
            else:
                print(f"invalid coordinate {coord!r}")
                continue
        else:
            continue
        print("Would you like to add another object? (yes/no)")
        while True:
            a = input().strip().lower()
            if a in ("no", "n"):
                done = True
                break
            if a in ("yes", "y"):
                done = False
                break
            print("Would you like to add another object? (yes/no)")
        if done:
            break

    builder = SceneBuilder().add_checkerboard()
    builder.load_board_map(board_map)
    scene = builder.build()
    types = {c: MENU_TYPES[t] for c, t in sorted(board_map.items())}
    print(f"scene: checkerboard + {types}")

    from .config import CameraConfig, RenderConfig
    size = args.size or 500
    cfg = RenderConfig(width=size, height=size,
                       max_depth=args.depth if args.depth is not None else 5,
                       samples=args.samples if args.samples is not None else 1,
                       seed=args.seed, mode=args.mode, prune=not args.no_prune)
    _render_and_write(scene, CameraConfig(), cfg, args.out)


def cmd_fit(args):
    _platform(args)
    import jax
    from .core.renderer import render_image
    from .diff.fit import FitParams, fit
    from .io.image import write_image
    from .ops.rays import Camera
    from .scene import presets
    from .utils.checkpoint import save_checkpoint

    scene, camcfg, cfg = presets.fit_target(size=args.size or 128)
    camera = Camera.from_config(camcfg, cfg.width, cfg.height)
    target = render_image(scene, camera, cfg)

    init = FitParams.from_scene(scene)
    rng = np.random.RandomState(args.seed)
    nv = int(np.asarray(scene.sph_valid).sum())
    dc = np.zeros((scene.num_spheres, 3), np.float32)
    dc[:nv] = rng.uniform(-8, 8, (nv, 3))
    init = init.replace(
        sph_center=init.sph_center + dc,
        sph_radius=init.sph_radius * (1 + rng.uniform(-0.15, 0.15, scene.num_spheres)).astype(np.float32),
        light_pos=init.light_pos + rng.uniform(-20, 20, (scene.num_lights, 3)).astype(np.float32))

    if args.views > 1:
        # robust config-4 recipe: orbit views + multiscale + soft-silhouette
        # annealing + restarts (diff/multiview.py)
        from .diff.multiview import (fit_multiview, orbit_views,
                                     recovery_report, render_views)
        views = orbit_views(camcfg, args.views, span_deg=args.span)
        targets = render_views(scene, views, cfg)
        full = cfg.width
        sizes = tuple(s for s in (full // 8, full // 4, full // 2)
                      if s >= 32)
        res = fit_multiview(scene, views, cfg, targets, init=init,
                            sizes=sizes,
                            steps_per_sigma=max(args.steps // 3, 10),
                            geom_lr=args.lr, seed=args.seed,
                            log_every=max(args.steps // 5, 1))
        params, history = res.params, res.history
        report = recovery_report(params, scene)
        print("recovery error (world units; board square = 40):")
        print(json.dumps(report, indent=2))
    else:
        params, history = fit(scene, camera, cfg, target, steps=args.steps,
                              learning_rate=args.lr, params=init,
                              log_every=max(args.steps // 10, 1))
        report = None
    print(f"loss: {history[0]:.6g} -> {history[-1]:.6g}")
    if args.out_dir:
        import os
        os.makedirs(args.out_dir, exist_ok=True)
        write_image(f"{args.out_dir}/target.png", np.asarray(target))
        final = render_image(params.into_scene(scene), camera, cfg)
        write_image(f"{args.out_dir}/fitted.png", np.asarray(final))
        save_checkpoint(f"{args.out_dir}/params.npz", params)
        with open(f"{args.out_dir}/history.json", "w") as f:
            json.dump(history, f)
        if report is not None:
            with open(f"{args.out_dir}/recovery.json", "w") as f:
                json.dump(report, f, indent=2)
        print(f"wrote target/fitted/params/history to {args.out_dir}")


def cmd_bench(args):
    _platform(args)
    import os
    if args.size:
        os.environ["BENCH_SIZE"] = str(args.size)
    if args.depth is not None:
        os.environ["BENCH_DEPTH"] = str(args.depth)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench
    bench.main()


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ray_tracer_fragment_shader_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a named preset scene")
    p.add_argument("--preset", default="reference_demo",
                   choices=["reference_demo", "single_sphere",
                            "three_spheres_ground", "full_reflective",
                            "fit_target", "procedural_spheres"])
    _add_common(p)
    p.add_argument("--watch", action="store_true",
                   help="progressive preview: render at 1/8, 1/4, 1/2 then "
                        "full resolution, rewriting --out after each pass")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("interactive",
                       help="build a scene via the reference's stdin menu")
    _add_common(p)
    p.set_defaults(fn=cmd_interactive)

    p = sub.add_parser("fit", help="differentiable fit workload")
    _add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.5)
    p.add_argument("--views", type=int, default=1,
                   help=">1 enables the robust multi-view recipe "
                        "(orbit cameras, multiscale, soft annealing)")
    p.add_argument("--span", type=float, default=90.0,
                   help="orbit azimuth span in degrees (--views > 1)")
    p.add_argument("--out-dir", default=None)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("bench", help="run the headline benchmark")
    _add_common(p)
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
