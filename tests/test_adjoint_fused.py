"""Fused in-kernel backward (kernels/adjoint_fused.py): gradient parity with
the XLA replay adjoint and with core autodiff (interpreter mode on CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tracer_fragment_shader_tpu.core.renderer import render_image
from ray_tracer_fragment_shader_tpu.diff.fit import FitParams
from ray_tracer_fragment_shader_tpu.kernels.adjoint import l2_loss_pallas
from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
    fit_value_and_grad)
from ray_tracer_fragment_shader_tpu.ops.rays import Camera
from ray_tracer_fragment_shader_tpu.scene import presets

SIZE = 32
FIELDS = ["sph_center", "sph_radius", "light_pos", "mat_diffuse",
          "mat_specular", "mat_ambient"]


@pytest.fixture(scope="module")
def setup():
    scene, camcfg, cfg = presets.full_reflective(size=SIZE)
    cam = Camera.from_config(camcfg, SIZE, SIZE)
    target = render_image(scene, cam, cfg)
    return scene, cam, cfg, target


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


def test_matches_replay_adjoint(setup):
    """Same pinned topology, same math — the two backends should agree to
    float32 reassociation error."""
    scene, cam, cfg, target = setup
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 1.5)

    loss_r, grads_r = jax.value_and_grad(l2_loss_pallas)(
        params, scene, cam, cfg, target, True)
    loss_f, grads_f = fit_value_and_grad(params, scene, cam, cfg, target,
                                         interpret=True)

    assert abs(float(loss_r) - float(loss_f)) <= 1e-6 * max(float(loss_r), 1)
    for fname in FIELDS:
        # block-order accumulation vs whole-image reductions: f32
        # reassociation puts the two backends ~1e-4 apart at worst
        r = _rel(getattr(grads_r, fname), getattr(grads_f, fname))
        assert r < 5e-4, f"{fname}: rel diff {r:.3g}"
        assert np.abs(np.asarray(getattr(grads_f, fname))).max() > 0


def test_matches_core_autodiff(setup):
    """Kernel grads (recompute backward) vs jax.grad of the XLA reference
    renderer, under a uniform cotangent (insensitive to the few
    decision-boundary pixels where kernel and core pick different hits —
    same device as test_adjoint.py)."""
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        recompute_grads_pallas)

    scene, cam, cfg, target = setup
    params = FitParams.from_scene(scene)

    grads_c = jax.grad(lambda p: jnp.mean(
        render_image(p.into_scene(scene), cam, cfg)))(params)

    g = jnp.full((SIZE, SIZE, 3), 1.0 / (SIZE * SIZE * 3), jnp.float32)
    grads_f = recompute_grads_pallas(scene, cam, cfg, g, interpret=True)

    # the kernel returns compacted sphere rows; core grads are padded
    take = np.nonzero(np.asarray(scene.sph_valid))[0]
    for fname, tol in [("sph_center", 5e-3), ("sph_radius", 5e-3),
                       ("light_pos", 3e-2), ("mat_diffuse", 3e-2),
                       ("mat_specular", 3e-2), ("mat_ambient", 3e-2)]:
        c = np.asarray(getattr(grads_c, fname))
        if fname.startswith("sph_"):
            c = c[take]
        r = _rel(c, grads_f[fname])
        assert r < tol, f"{fname}: rel diff {r:.3g}"


def _partials_with_block(scene, cam, cfg, g, block):
    """The recompute backward's reduced gradient tables with a chosen
    (pixels per program, warps) block."""
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        _backward_call, _recompute_bwd_kernel)
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        compact_scene, pack_scene_for, pad_plane, ray_planes)
    from ray_tracer_fragment_shader_tpu.ops.rays import screen_points
    scene = compact_scene(scene)
    packed = pack_scene_for(scene, cam)
    pts = screen_points(cam, cfg.width, cfg.height)
    planes = ray_planes(cam, pts, block[0]) + tuple(
        pad_plane(g[..., k], block[0]) for k in range(3))
    return _backward_call(_recompute_bwd_kernel, "t", packed, scene, cfg,
                          planes, interpret=True, block=block)[1]


def test_block_partials_match_single_block(setup):
    """Each program writes its own row of partial sums and XLA sums the
    rows: the result equals a run in which one program covers the whole
    frame (one row, no cross-program reduction) up to f32 reassociation."""
    scene, cam, cfg, target = setup
    g = (render_image(scene, cam, cfg) - 0.9 * target) * 1e-3
    one = _partials_with_block(scene, cam, cfg, g, (SIZE * SIZE, 4))
    many = _partials_with_block(scene, cam, cfg, g, (64, 4))
    for k in one:
        r = _rel(one[k], many[k])
        assert r < 1e-5, f"{k}: rel diff {r:.3g}"
        assert np.abs(np.asarray(one[k])).max() > 0


def test_recompute_matches_twophase(setup):
    """The two backward kernels — packed two-phase (cotangent formed
    in-kernel) and recompute (cotangent passed in) — run the same adjoint
    on the same topology: equal gradients to f32 noise."""
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        recompute_grads_pallas, twophase_loss_grads_pallas)
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_image_pallas)
    scene, cam, cfg, target = setup
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 1.5)
    scene_p = params.into_scene(scene)
    denom = float(SIZE * SIZE * 3)
    sq, g_t = twophase_loss_grads_pallas(scene_p, cam, cfg, target,
                                         interpret=True)
    img = render_image_pallas(scene_p, cam, cfg, interpret=True)
    g_r = recompute_grads_pallas(scene_p, cam, cfg,
                                 (2.0 / denom) * (img - target),
                                 interpret=True)
    assert float(sq) == pytest.approx(float(jnp.sum((img - target) ** 2)),
                                      rel=1e-5)
    for k in g_t:
        r = _rel(g_t[k], g_r[k])
        assert r < 1e-5, f"{k}: rel diff {r:.3g}"


def test_twophase_packed_transmitting_chain():
    """Packed two-phase on a chain-exact scene WITH full transparency
    (the Snell/select branch live) and 2 lights (two lit bits in the
    packed plane) vs the float64 replay through the kernel's own topology
    on the stable pixels (oracle/replay64.py)."""
    from ray_tracer_fragment_shader_tpu.oracle.replay64 import (
        masked_grads_vs_replay64)
    from ray_tracer_fragment_shader_tpu.scene import (Material, SceneBuilder)
    from ray_tracer_fragment_shader_tpu.scene import presets
    glass = Material(ambient=(0.02, 0.02, 0.02), diffuse=(0.1, 0.1, 0.2),
                     specular=(0.4, 0.4, 0.4), transparency=(1.0, 1.0, 1.0),
                     refraction=0.9)
    scene = (SceneBuilder().add_checkerboard()
             .add_sphere("d5", material=glass).add_sphere("c3")
             .add_light("b6").add_light("f7", color=(0.8, 0.9, 1.0))
             .build())
    assert scene.chain_exact and scene.has_transmission
    size = 64   # the spheres need a few pixels of stable topology
    camcfg = presets._cam(size)
    cfg = presets.fit_target(size=size)[2]
    cam = Camera.from_config(camcfg, size, size)
    target = render_image(scene, cam, cfg)
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 1.0)
    g_t, g_64, share = masked_grads_vs_replay64(
        params, scene, cam, cfg, target, interpret=True)
    assert share > 0.3
    for fname in FIELDS:
        r = _rel(getattr(g_64, fname), getattr(g_t, fname))
        assert r < 5e-4, f"{fname}: rel diff {r:.3g}"
        assert np.abs(np.asarray(getattr(g_t, fname))).max() > 0


def test_pack_widths_bounds():
    """Field widths are powers of two covering the tables, and the f32
    exact-integer budget is enforced."""
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        pack_widths)
    bw_bi, bw_mid = pack_widths(nt=2, ns=64, m=5, nl=2)
    assert bw_bi >= 2 + 64 + 2 and bw_mid >= 6
    assert (bw_bi & (bw_bi - 1) == 0) if isinstance(bw_bi, int) else True
    with pytest.raises(ValueError, match="packed residual"):
        pack_widths(nt=0, ns=2 ** 20, m=100, nl=7)


def test_fused_fit_descends(setup):
    scene, cam, cfg, target = setup
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 2.0)
    opt = optax.adam(0.05)
    state = opt.init(params)
    losses = []
    for _ in range(6):
        loss, grads = fit_value_and_grad(params, scene, cam, cfg, target,
                                         interpret=True)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_jits(setup):
    scene, cam, cfg, target = setup
    params = FitParams.from_scene(scene)
    loss, grads = jax.jit(
        lambda p: fit_value_and_grad(p, scene, cam, cfg, target,
                                     interpret=True))(params)
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(grads.sph_center)).all()


def test_prepared_inputs_match_inline(setup):
    """prepare_fit_inputs + prep= must be bit-identical to the inline path
    (same planes, same kernels), with every plane padded so that both the
    forward and the backward block divide it."""
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        prepare_fit_inputs)
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        BWD_BLOCK, FWD_BLOCK, PLANE_MULT)
    scene, cam, cfg, target = setup
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 1.0)

    loss_i, grads_i = fit_value_and_grad(params, scene, cam, cfg, target,
                                         interpret=True)
    prep = prepare_fit_inputs(cam, cfg, target)
    loss_p, grads_p = fit_value_and_grad(params, scene, cam, cfg, target,
                                         interpret=True, prep=prep)
    assert float(loss_i) == float(loss_p)
    for fname in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(grads_i, fname)),
                                      np.asarray(getattr(grads_p, fname)))
    for k in ("vx", "tr", "mask"):
        (n,) = prep[k].shape
        assert n % PLANE_MULT == 0 and n >= SIZE * SIZE
        assert n % FWD_BLOCK[0] == 0 and n % BWD_BLOCK[0] == 0
    assert float(jnp.sum(prep["mask"])) == SIZE * SIZE


def test_prep_provenance_checked(setup):
    """A stale prep passed alongside a DIFFERENT target must raise, not
    silently compute gradients against the old target (ADVICE r3, medium);
    target=None explicitly defers to the prep's planes."""
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        prepare_fit_inputs)
    scene, cam, cfg, target = setup
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 1.0)
    prep = prepare_fit_inputs(cam, cfg, target)

    other_target = target * 0.5
    with pytest.raises(ValueError, match="different `target`"):
        fit_value_and_grad(params, scene, cam, cfg, other_target,
                           interpret=True, prep=prep)

    # the sanctioned way to say "use the prep's planes"
    loss_none, _ = fit_value_and_grad(params, scene, cam, cfg, None,
                                      interpret=True, prep=prep)
    loss_same, _ = fit_value_and_grad(params, scene, cam, cfg, target,
                                      interpret=True, prep=prep)
    assert float(loss_none) == float(loss_same)


def test_make_fit_step_pallas_descends(setup):
    """The user-facing kernel fit-step constructor (prep hoisted once)
    descends and matches the un-prepped loss on its first step."""
    from ray_tracer_fragment_shader_tpu.diff.fit import make_fit_step_pallas
    scene, cam, cfg, target = setup
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 2.0)
    opt = optax.adam(0.05)
    state = opt.init(params)
    step = make_fit_step_pallas(scene, cam, cfg, target, opt,
                                interpret=True)

    loss_ref, _ = fit_value_and_grad(params, scene, cam, cfg, target,
                                     interpret=True)
    losses = []
    for _ in range(6):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    assert losses[0] == pytest.approx(float(loss_ref), rel=1e-6)
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_adaptive_matches_replay_backward_per_sample(setup):
    """Adaptive supersampling (the reference's default render mode) on the
    kernel fast path, with REAL jitter: constant-color regions converge at
    k=1 (divisor quirk) while detailed pixels accept all samples, so the
    accept/divisor planes are genuinely mixed.  The fast path's gradients
    must equal the sum of per-sample backward gradients computed here
    (the per-sample recompute kernel, ``recompute_grads_pallas``) weighted
    by accept_k / divisor planes this test records itself — an
    independent implementation of the adaptive weighting."""
    import dataclasses

    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        grads_to_fitparams, recompute_grads_pallas)
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_image_pallas)
    from ray_tracer_fragment_shader_tpu.ops.rays import (sample_jitter,
                                                         screen_points)

    scene, cam, cfg = setup[0], setup[1], setup[2]
    S = 3
    cfg_a = dataclasses.replace(cfg, samples=S, adaptive=True)
    cfg1 = dataclasses.replace(cfg, samples=1, force_jitter=False)
    target = render_image_pallas(scene, cam, cfg_a, interpret=True) * 0.9
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 0.3)
    scene_p = params.into_scene(scene)

    loss_a, g_a = fit_value_and_grad(params, scene, cam, cfg_a, target,
                                     interpret=True)

    # reproduce the forward emulation to get img/accepts/divisor (this
    # replication is exact: same kernels, same PRNG stream)
    keys = jax.random.split(jax.random.PRNGKey(cfg_a.seed), S)
    pts0 = screen_points(cam, SIZE, SIZE)
    accum = jnp.zeros((SIZE, SIZE, 3), jnp.float32)
    divisor = jnp.full((SIZE, SIZE), float(S), jnp.float32)
    done = jnp.zeros((SIZE, SIZE), bool)
    accepts, jits = [], []
    for k in range(S):
        jit = sample_jitter(keys[k], pts0.shape[0], cfg_a.jitter_scale,
                            dtype=pts0.dtype)
        jits.append(jit)
        c = render_image_pallas(scene_p, cam, cfg1, pts=pts0 + jit,
                                interpret=True)
        accepts.append(jnp.logical_not(done))
        accum_after = jnp.where(done[..., None], accum, accum + c)
        d = k * accum_after - (k + 1.0) * accum
        dnorm = jnp.sqrt(jnp.sum(d * d, -1))
        newly = jnp.logical_and(~done,
                                dnorm < cfg.small_number * k * (k + 1.0))
        divisor = jnp.where(newly, float(k), divisor)
        done = jnp.logical_or(done, newly)
        accum = accum_after
    img = accum / divisor[..., None]
    # the accept planes must actually be mixed for this test to bite
    assert 0 < float(jnp.mean(jnp.where(accepts[-1], 1.0, 0.0))) < 1
    g = (2.0 / img.size) * (img - target)

    # independent weighting: per-sample backward kernel with the
    # accept_k/divisor weights recorded above
    expected = None
    for k in range(S):
        wk = jnp.where(accepts[k], 1.0, 0.0) / divisor
        gk = recompute_grads_pallas(scene_p, cam, cfg1, g * wk[..., None],
                                    interpret=True, pts=pts0 + jits[k])
        expected = gk if expected is None else jax.tree_util.tree_map(
            jnp.add, expected, gk)
    g_e = grads_to_fitparams(params, scene_p, expected)

    loss_direct = float(jnp.mean((img - target) ** 2))
    assert float(loss_a) == pytest.approx(loss_direct, rel=1e-5)
    for fname in FIELDS:
        r = _rel(getattr(g_e, fname), getattr(g_a, fname))
        assert r < 5e-4, f"{fname}: rel diff {r:.3g}"
        assert np.abs(np.asarray(getattr(g_a, fname))).max() > 0


def test_adaptive_divisor_quirk_gradient():
    """Zero jitter: every pixel converges at k=1 with divisor 1 but TWO
    accumulated samples (the preserved reference quirk,
    test_adaptive.py::test_divisor_quirk_on_identical_samples), so
    img = 2c.  Under fixed topology d/dp mean((2c - t)^2) =
    2 * d/dp mean((c - (t - c0))^2) with c0 = stop_grad(c) — so the
    adaptive fast-path gradients must equal exactly 2x the single-sample
    gradients at the shifted target.  Cross-checks the accept/divisor
    weighting against the independently-tested single-sample path with no
    core-vs-kernel boundary-pixel noise."""
    import dataclasses

    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        render_image_pallas)
    from ray_tracer_fragment_shader_tpu.scene import presets as _p
    scene, camcfg, cfg = _p.fit_target(size=SIZE)
    cam = Camera.from_config(camcfg, SIZE, SIZE)
    cfg_a = dataclasses.replace(cfg, samples=4, adaptive=True,
                                force_jitter=True, jitter_scale=0.0)
    params = FitParams.from_scene(scene).replace(
        sph_center=scene.sph_center + 0.3)
    scene_p = params.into_scene(scene)
    c0 = render_image_pallas(scene_p, cam, cfg,
                             interpret=True)                # single sample
    img_a = render_image_pallas(scene_p, cam, cfg_a, interpret=True)
    np.testing.assert_allclose(np.asarray(img_a), np.asarray(2.0 * c0),
                               rtol=1e-6)            # the quirk itself
    target = render_image_pallas(scene, cam, cfg_a, interpret=True) * 0.9

    loss_a, g_a = fit_value_and_grad(params, scene, cam, cfg_a, target,
                                     interpret=True)
    loss_1, g_1 = fit_value_and_grad(params, scene, cam, cfg,
                                     target - np.asarray(c0),
                                     interpret=True)
    assert float(loss_a) == pytest.approx(
        float(np.mean((np.asarray(img_a) - np.asarray(target)) ** 2)),
        rel=1e-5)
    for fname in FIELDS:
        a = np.asarray(getattr(g_a, fname))
        b = 2.0 * np.asarray(getattr(g_1, fname))
        r = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert r < 1e-4, f"{fname}: rel diff {r:.3g}"
        assert np.abs(a).max() > 0


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_grad_layout_power_of_two_for_every_preset(name):
    """Every preset's per-program partial-sum row (loss + sphere, material
    and light fields) fits a power-of-two width — what Triton stores — with
    no slot to spare beyond the padding."""
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        grad_layout)
    from ray_tracer_fragment_shader_tpu.kernels.render_pallas import (
        compact_scene)
    scene = compact_scene(presets.PRESETS[name]()[0])
    used, width = grad_layout(max(scene.num_spheres, 1),
                              scene.num_materials, scene.num_lights)
    assert used == (1 + 4 * max(scene.num_spheres, 1)
                    + 9 * scene.num_materials + 3 * scene.num_lights)
    assert width & (width - 1) == 0
    assert width // 2 < used <= width
