"""Smoke test of the whole system on the GPU: the renderer and the fit step
through the entry points a user calls, with every Pallas kernel compiled for
the card (none in interpret mode), each compared with the repo's own
references.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded phase only

One process drives the card(s).  Phases (each raises on failure, so the
script exits non-zero and prints no result):

  forward    BASELINE config 3 (``full_reflective``, 1024^2, depth 3):
             ``render_image_pallas`` vs ``jax.jit(render_image)``
             (the XLA core renderer), then both vs the f64 C++ oracle.
  fit        config 3: the two-phase fit kernels vs the float64 replay
             through the kernel's own hit topology, on the pixels whose
             topology is constant over their 3x3 neighborhood
             (oracle/replay64.py); ``fit_value_and_grad`` vs the XLA
             replay VJP (loss) with the whole-frame gradient differences
             to it and to XLA autodiff of the core renderer printed; a few
             Adam steps of ``make_fit_step_pallas``.
  reference  the reference's own frame (``reference_demo``: 500^2, depth 5,
             16-sample adaptive supersampling): both forwards, both vs the
             oracle at one centred sample (the oracle has no jitter), the
             supersampled fit's loss, and its per-sample backward kernel
             vs the float64 replay on two of its jittered samples.
  grad_bar   the BASELINE gradient bar (max-abs-err 1e-4 vs f64 finite
             differences, oracle/gradcheck.py) on the card's arithmetic.
  cli        ``cli.main(["render", ...])`` and ``cli.main(["fit", ...])``
             in this process.
  timing     each kernel end to end beside what XLA makes of the plain
             version: median of 20 calls after warm-up, each ended by
             ``block_until_ready``.
  sharded    (--four only) ``make_sharded_fit_step_pallas`` and
             ``render_image_sharded(backend="pallas")`` on a 4-device 1-D
             mesh vs the one-card ``fit_value_and_grad``.

Every comparison runs under ``jax.default_matmul_precision("highest")``:
the path has no matrix product today, and a new one must not run as TF32.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ONE_CARD_PHASES = ("forward", "fit", "reference", "grad_bar", "cli",
                   "timing")
FOUR_CARD_PHASES = ("sharded",)

FIELDS = ("sph_center", "sph_radius", "light_pos", "mat_diffuse",
          "mat_specular", "mat_ambient")


def select_phases(four: bool):
    """The phases a run executes: the sharded phase alone with ``--four``,
    every one-card phase otherwise."""
    return FOUR_CARD_PHASES if four else ONE_CARD_PHASES


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, value: float, limit: float, what: str) -> None:
    """Print one comparison with its tolerance; raise when it fails."""
    ok = value <= limit
    log(f"  [{'ok' if ok else 'FAIL'}] {name}: {what} = {value:.3e} "
        f"(limit {limit:.0e})")
    if not ok:
        raise AssertionError(f"{name}: {what} {value:.3e} > {limit:.0e}")


def frac_over(a, b, tol: float) -> float:
    """Share of pixels whose max-over-channels error exceeds ``tol``."""
    import numpy as np
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float((d.max(-1) > tol).mean())


def rel_diff(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def compare_grads(name, got, ref, limit):
    import numpy as np
    for f in FIELDS:
        g = np.asarray(getattr(got, f))
        if not np.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite {f} gradient")
        check(f"{name} {f}", rel_diff(g, getattr(ref, f)), limit,
              "max rel diff")


def timed(label: str, fn, iters: int = 20):
    from ray_tracer_fragment_shader_tpu.utils.timing import median_time
    t = median_time(fn, iters=iters)
    log(f"  time {label}: median {t['median_s'] * 1e3:.3f} ms "
        f"(min {t['min_s'] * 1e3:.3f}, max {t['max_s'] * 1e3:.3f}, "
        f"{iters} calls after warm-up; warm-up incl. compile "
        f"{t['warmup_s']:.1f} s)")
    return t["median_s"]


class Ctx:
    """Scenes, cameras and jitted entry points shared by the phases."""

    def __init__(self):
        from ray_tracer_fragment_shader_tpu.ops.rays import Camera
        from ray_tracer_fragment_shader_tpu.scene import presets
        self.scene, self.camcfg, self.cfg = presets.full_reflective(
            size=1024, depth=3)
        self.cam = Camera.from_config(self.camcfg, 1024, 1024)
        sd, cd, cfgd = presets.reference_demo()
        self.demo = (sd, cd, dataclasses.replace(cfgd, adaptive=True))
        self.demo_cam = Camera.from_config(cd, cfgd.width, cfgd.height)
        self._target = None

    @property
    def target(self):
        """The XLA core render of config 3 (the fit phases' target)."""
        if self._target is None:
            import jax
            from ray_tracer_fragment_shader_tpu.core.renderer import (
                render_image)
            self._target = jax.jit(lambda s: render_image(
                s, self.cam, self.cfg))(self.scene)
        return self._target


def phase_forward(ctx):
    import jax
    import numpy as np
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_image_pallas)
    from ray_tracer_fragment_shader_tpu.oracle.native import (
        cpp_oracle_render)
    s, cam, cfg = ctx.scene, ctx.cam, ctx.cfg
    img_k = np.asarray(jax.jit(lambda s: render_image_pallas(s, cam, cfg))(s))
    img_x = np.asarray(ctx.target)
    log(f"  config 3 {cfg.width}x{cfg.height} depth {cfg.max_depth}: "
        f"kernel mean {img_k.mean():.6f}, XLA mean {img_x.mean():.6f}")
    check("forward kernel vs XLA", frac_over(img_k, img_x, 1e-3), 0.01,
          "share of pixels with error > 1e-3")
    ref = cpp_oracle_render(s, ctx.camcfg, cfg)
    check("forward kernel vs f64 oracle", frac_over(img_k, ref, 2e-3),
          0.001, "share of pixels with error > 2e-3")
    check("forward XLA vs f64 oracle", frac_over(img_x, ref, 2e-3), 0.001,
          "share of pixels with error > 2e-3")


def compare_to_replay64(name, params, scene, cam, cfg, target,
                        kernel="twophase", pts=None):
    """A backward kernel vs the float64 replay through the kernel's own hit
    topology, for the L2 cotangent on pixels whose topology is constant
    over their 3x3 neighborhood (oracle/replay64.py): equal to float32
    accuracy."""
    import numpy as np
    from ray_tracer_fragment_shader_tpu.oracle.replay64 import (
        masked_grads_vs_replay64)
    g_k, g_64, share = masked_grads_vs_replay64(
        params, scene, cam, cfg, target, kernel=kernel, pts=pts)
    log(f"  {name}: {kernel} kernel on the {share:.1%} of pixels with "
        f"stable topology")
    for f in FIELDS:
        g = np.asarray(getattr(g_k, f))
        if not np.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite {f} gradient")
        check(f"{name} grads {kernel} kernel vs f64 replay {f}",
              rel_diff(g, getattr(g_64, f)), 5e-4, "max rel diff")


def log_diffs(name, g_k, g_x, what):
    """Printed, not gated: on the whole frame the f32 gradients are
    dominated by silhouette pixels (grazing hits, ill-conditioned) and by
    the few pixels where two f32 renderers pick different hits."""
    for f in FIELDS:
        log(f"  {name} kernel vs {what} {f}: max rel diff "
            f"{rel_diff(getattr(g_k, f), getattr(g_x, f)):.3e} (not gated)")


def phase_fit(ctx):
    import jax
    import numpy as np
    import optax
    from ray_tracer_fragment_shader_tpu.diff.fit import (
        FitParams, l2_loss, make_fit_step_pallas)
    from ray_tracer_fragment_shader_tpu.kernels.adjoint import (
        l2_loss_pallas)
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        fit_value_and_grad)
    s, cam, cfg = ctx.scene, ctx.cam, ctx.cfg
    target = ctx.target
    params = FitParams.from_scene(s).replace(sph_center=s.sph_center + 1.5)
    compare_to_replay64("config 3 fit", params, s, cam, cfg, target)
    loss_k, g_k = jax.jit(lambda p: fit_value_and_grad(
        p, s, cam, cfg, target))(params)
    loss_r, g_r = jax.jit(lambda p: jax.value_and_grad(l2_loss_pallas)(
        p, s, cam, cfg, target))(params)
    loss_x, g_x = jax.jit(lambda p: jax.value_and_grad(l2_loss)(
        p, s, cam, cfg, target))(params)
    log(f"  config 3 loss: kernel {float(loss_k):.8g}, kernel forward + "
        f"XLA replay VJP {float(loss_r):.8g}, XLA autodiff "
        f"{float(loss_x):.8g}")
    check("config 3 fit loss kernel vs replay VJP",
          abs(float(loss_k) - float(loss_r)) / float(loss_r), 1e-5,
          "rel diff")
    log_diffs("config 3 fit", g_k, g_r, "f32 XLA replay VJP")
    log_diffs("config 3 fit", g_k, g_x, "XLA autodiff")
    opt = optax.adam(0.05)
    step = make_fit_step_pallas(s, cam, cfg, target, opt)
    state = opt.init(params)
    losses = []
    for _ in range(5):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    log(f"  make_fit_step_pallas losses: {losses}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"fit step did not lower the loss: {losses}")


def phase_reference(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ray_tracer_fragment_shader_tpu.core.renderer import render_image
    from ray_tracer_fragment_shader_tpu.diff.fit import FitParams, l2_loss
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        fit_value_and_grad)
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_image_pallas)
    from ray_tracer_fragment_shader_tpu.ops.rays import (sample_jitter,
                                                         screen_points)
    from ray_tracer_fragment_shader_tpu.oracle.native import (
        cpp_oracle_render)
    s, camcfg, cfg = ctx.demo
    cam = ctx.demo_cam
    img_k = np.asarray(jax.jit(lambda s: render_image_pallas(s, cam, cfg))(s))
    img_x = np.asarray(jax.jit(lambda s: render_image(s, cam, cfg))(s))
    log(f"  reference frame {cfg.width}x{cfg.height} depth {cfg.max_depth} "
        f"{cfg.samples} samples adaptive: kernel mean {img_k.mean():.6f}, "
        f"XLA mean {img_x.mean():.6f}")
    check("reference forward kernel vs XLA", frac_over(img_k, img_x, 1e-3),
          0.01, "share of pixels with error > 1e-3")
    cfg1 = dataclasses.replace(cfg, samples=1, adaptive=False)
    one_k = jax.jit(lambda s: render_image_pallas(s, cam, cfg1))(s)
    one_x = jax.jit(lambda s: render_image(s, cam, cfg1))(s)
    ref = cpp_oracle_render(s, camcfg, cfg1)
    # the reference's 1:1 pixel scale puts one whole image row (500 pixels,
    # 0.2% of the frame) on the board-plane horizon, where checker parity
    # is decided by the last bit in f32 — a budget of one row plus 0.05%
    check("reference (1 sample) kernel vs f64 oracle",
          frac_over(one_k, ref, 2e-3), 0.0025,
          "share of pixels with error > 2e-3")
    check("reference (1 sample) XLA vs f64 oracle",
          frac_over(one_x, ref, 2e-3), 0.0025,
          "share of pixels with error > 2e-3")
    target = img_x * 0.9
    params = FitParams.from_scene(s)
    loss_k, g_k = jax.jit(lambda p: fit_value_and_grad(
        p, s, cam, cfg, target))(params)
    loss_x, g_x = jax.jit(lambda p: jax.value_and_grad(l2_loss)(
        p, s, cam, cfg, target))(params)
    loss_img = float(jnp.mean((img_k - target) ** 2))
    log(f"  reference fit loss: kernel {float(loss_k):.8g}, from the kernel "
        f"image {loss_img:.8g}, XLA autodiff {float(loss_x):.8g}")
    check("reference fit loss vs the kernel image's",
          abs(float(loss_k) - loss_img) / loss_img, 1e-5, "rel diff")
    for f in FIELDS:
        if not np.isfinite(np.asarray(getattr(g_k, f))).all():
            raise AssertionError(f"reference fit: non-finite {f} gradient")
    log_diffs("reference fit", g_k, g_x, "XLA autodiff")
    # the per-sample backward kernel of that fit, on two of its jittered
    # samples (same PRNG stream as fit_value_and_grad)
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.samples)
    pts0 = screen_points(cam, cfg.width, cfg.height)
    for k in (0, 1):
        pts = pts0 + sample_jitter(keys[k], pts0.shape[0], cfg.jitter_scale)
        compare_to_replay64(f"reference sample {k}", params, s, cam, cfg,
                            target, kernel="recompute", pts=pts)


def phase_grad_bar(ctx):
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        recompute_grads_pallas)
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        compact_scene)
    from ray_tracer_fragment_shader_tpu.oracle.gradcheck import run_grad_bar
    from ray_tracer_fragment_shader_tpu.scene import presets
    scene, camcfg, cfg = presets.fit_target(size=128)

    def grads_fn(cam, g):
        return recompute_grads_pallas(compact_scene(scene), cam, cfg, g)

    s = run_grad_bar(scene, camcfg, cfg, grads_fn)
    log(f"  grad bar fit_target 128^2: {s['n_checks']} FD checks, "
        f"|grad|max {s['grad_scale']:.3e}, worst {s['worst']}")
    if s["grad_scale"] <= 1e-3:
        raise AssertionError("grad bar degenerate: all-zero gradients")
    check("grad bar (compiled kernel vs f64 FD)", s["max_abs_err"], 1e-4,
          "max abs err")


def phase_cli(ctx):
    from ray_tracer_fragment_shader_tpu import cli
    from ray_tracer_fragment_shader_tpu.io.image import read_png
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "demo.png")
        cli.main(["render", "--preset", "reference_demo", "--out", out])
        img = read_png(out)
        log(f"  cli render: {img.shape} mean {img.mean():.2f}")
        if img.shape != (500, 500, 3) or img.mean() <= 0:
            raise AssertionError("cli render wrote a bad image")
        cli.main(["fit", "--steps", "5", "--size", "64",
                  "--out-dir", os.path.join(tmp, "fit")])
        with open(os.path.join(tmp, "fit", "history.json")) as f:
            hist = json.load(f)
        log(f"  cli fit history: {hist}")
        if len(hist) != 5 or not all(map(lambda x: x == x, hist)):
            raise AssertionError("cli fit wrote a bad history")


def phase_timing(ctx):
    import jax
    from ray_tracer_fragment_shader_tpu.core.renderer import render_image
    from ray_tracer_fragment_shader_tpu.diff.fit import (FitParams, l2_loss,
                                                         make_fit_step)
    from ray_tracer_fragment_shader_tpu.kernels.adjoint import (
        l2_loss_pallas)
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        fit_value_and_grad, prepare_fit_inputs)
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_image_pallas)
    import optax
    s, cam, cfg = ctx.scene, ctx.cam, ctx.cfg
    target = ctx.target
    params = FitParams.from_scene(s)
    log("  config 3, 1024^2, depth 3:")
    fk = jax.jit(lambda s: render_image_pallas(s, cam, cfg))
    fx = jax.jit(lambda s: render_image(s, cam, cfg))
    timed("forward kernel", lambda: fk(s))
    timed("forward XLA jit(render_image)", lambda: fx(s))
    prep = prepare_fit_inputs(cam, cfg, target)
    gk = jax.jit(lambda p: fit_value_and_grad(p, s, cam, cfg, target,
                                              prep=prep))
    gr = jax.jit(lambda p: jax.value_and_grad(l2_loss_pallas)(
        p, s, cam, cfg, target))
    gx = jax.jit(lambda p: jax.value_and_grad(l2_loss)(
        p, s, cam, cfg, target))
    timed("fwd+bwd kernels (two-phase fit_value_and_grad)",
          lambda: gk(params))
    timed("fwd+bwd kernel forward + XLA replay VJP (l2_loss_pallas)",
          lambda: gr(params))
    timed("fwd+bwd XLA autodiff (value_and_grad(l2_loss))",
          lambda: gx(params))
    opt = optax.adam(0.05)
    state = opt.init(params)
    step_x = make_fit_step(s, cam, cfg, target, opt)
    timed("Adam step XLA make_fit_step", lambda: step_x(params, state))
    from ray_tracer_fragment_shader_tpu.diff.fit import make_fit_step_pallas
    step_k = make_fit_step_pallas(s, cam, cfg, target, opt)
    timed("Adam step kernels make_fit_step_pallas",
          lambda: step_k(params, state))
    sd, _, cfgd = ctx.demo
    camd = ctx.demo_cam
    log("  reference frame, 500^2, depth 5, 16 samples adaptive:")
    fkd = jax.jit(lambda s: render_image_pallas(s, camd, cfgd))
    fxd = jax.jit(lambda s: render_image(s, camd, cfgd))
    timed("forward kernel", lambda: fkd(sd), iters=20)
    timed("forward XLA", lambda: fxd(sd), iters=20)
    pd = FitParams.from_scene(sd)
    tgt = fxd(sd) * 0.9
    gkd = jax.jit(lambda p: fit_value_and_grad(p, sd, camd, cfgd, tgt))
    gxd = jax.jit(lambda p: jax.value_and_grad(l2_loss)(
        p, sd, camd, cfgd, tgt))
    timed("fwd+bwd kernels (recompute backward)", lambda: gkd(pd), iters=20)
    timed("fwd+bwd XLA autodiff", lambda: gxd(pd), iters=20)


def phase_sharded(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from ray_tracer_fragment_shader_tpu.diff.fit import (
        FitParams, make_sharded_fit_step_pallas)
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        fit_value_and_grad)
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_image_pallas)
    from ray_tracer_fragment_shader_tpu.parallel.mesh import make_mesh
    from ray_tracer_fragment_shader_tpu.parallel.shard import (
        render_image_sharded)
    s, cam, cfg = ctx.scene, ctx.cam, ctx.cfg
    mesh = make_mesh(jax.devices()[:4])
    img_m = np.asarray(render_image_sharded(s, cam, cfg, mesh,
                                            backend="pallas"))
    img_1 = np.asarray(jax.jit(lambda s: render_image_pallas(s, cam, cfg))(
        s))
    # the same kernel on the same rays; the screen points of a band may
    # differ from the full frame's in the last bit (another fusion), which
    # can flip a decision-boundary pixel
    check("sharded forward (4 cards) vs one card",
          frac_over(img_m, img_1, 1e-3), 1e-4,
          "share of pixels with error > 1e-3")
    target = ctx.target
    params = FitParams.from_scene(s).replace(sph_center=s.sph_center + 1.5)

    # an "optimizer" whose state is the gradient it was handed, so the
    # sharded step's psum'd gradients can be compared field by field
    keep_grads = optax.GradientTransformation(
        init=lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        update=lambda g, st, p=None: (
            jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step, tgt = make_sharded_fit_step_pallas(s, cam, cfg, target,
                                             keep_grads, mesh)
    _, g_m, loss_m = step(params, keep_grads.init(params), tgt)
    loss_1, g_1 = jax.jit(lambda p: fit_value_and_grad(
        p, s, cam, cfg, target))(params)
    log(f"  sharded loss {float(loss_m):.8g}, one card {float(loss_1):.8g}")
    check("sharded fit loss vs one card",
          abs(float(loss_m) - float(loss_1)) / float(loss_1), 1e-5,
          "rel diff")
    compare_grads("sharded fit grads vs one card", g_m, g_1, 5e-4)
    opt = optax.adam(0.05)
    step_a, tgt_a = make_sharded_fit_step_pallas(s, cam, cfg, target, opt,
                                                 mesh)
    state = opt.init(params)
    one = jax.jit(lambda p: fit_value_and_grad(p, s, cam, cfg, target))
    timed("sharded Adam step (4 cards)",
          lambda: step_a(params, state, tgt_a))
    timed("one-card fit_value_and_grad", lambda: one(params))


PHASES = dict(forward=phase_forward, fit=phase_fit,
              reference=phase_reference, grad_bar=phase_grad_bar,
              cli=phase_cli, timing=phase_timing, sharded=phase_sharded)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the sharded phase on four GPUs (and nothing "
                         "else)")
    args = ap.parse_args(argv)

    import jax
    from ray_tracer_fragment_shader_tpu.utils.cache import (
        enable_compile_cache)
    from ray_tracer_fragment_shader_tpu.utils.timing import (
        gpu_name_and_power_limit, require_gpu)
    try:
        devices = require_gpu()
    except RuntimeError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    count = 4 if args.four else 1
    if len(devices) < count:
        print(f"chip_smoke: needs {count} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    log(gpu_name_and_power_limit())
    log(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}; "
        f"all comparisons under jax.default_matmul_precision('highest')")
    ctx = Ctx()
    t_all = time.time()
    with jax.default_matmul_precision("highest"):
        for name in select_phases(args.four):
            t0 = time.time()
            log(f"phase {name}:")
            PHASES[name](ctx)
            log(f"phase {name} done in {time.time() - t0:.1f} s")
    log(f"all phases done in {time.time() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
