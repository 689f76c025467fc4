"""What decides where code runs, and the pieces around it: the device
choice of the kernels, the Triton lowering of every kernel (checked here by
lowering for CUDA on the CPU), the compile-cache directory, chip_smoke.py
without a GPU, the standard-library PNG writer and the dataclass pytrees."""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracer_fragment_shader_tpu.kernels import render_pallas
from ray_tracer_fragment_shader_tpu.ops.rays import Camera
from ray_tracer_fragment_shader_tpu.scene import presets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kernels_refuse_cpu_without_interpret():
    scene, camcfg, cfg = presets.single_sphere(size=8)
    with pytest.raises(RuntimeError, match="interpret=True"):
        render_pallas.render_image_pallas(scene, camcfg, cfg)
    with pytest.raises(RuntimeError, match="GPU"):
        render_pallas.use_interpret(False)


def test_device_choice(monkeypatch):
    """Interpret mode only when asked for; compiled kernels on a GPU."""
    assert render_pallas.use_interpret(True) is True
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert render_pallas.use_interpret(None) is False
    assert render_pallas.use_interpret(False) is False
    assert render_pallas.use_interpret(True) is True


def _lower_for_cuda(monkeypatch, fn, *args):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    return text.count("__gpu$xla.gpu.triton")


@pytest.mark.parametrize("what", ["forward", "twophase", "recompute"])
def test_kernels_lower_through_triton(monkeypatch, what):
    """Every kernel lowers on the Triton route (power-of-two loads and
    stores, no primitive without a Triton rule).  Only the GPU compiler
    itself is left for the card."""
    import dataclasses

    from ray_tracer_fragment_shader_tpu.diff.fit import FitParams
    from ray_tracer_fragment_shader_tpu.kernels.adjoint_fused import (
        fit_value_and_grad)
    scene, camcfg, cfg = presets.full_reflective(size=24, depth=2)
    cam = Camera.from_config(camcfg, 24, 24)
    target = jnp.zeros((24, 24, 3), jnp.float32)
    params = FitParams.from_scene(scene)
    if what == "forward":
        n = _lower_for_cuda(monkeypatch, lambda s: render_pallas.
                            render_image_pallas(s, cam, cfg), scene)
    else:
        if what == "recompute":
            cfg = dataclasses.replace(cfg, samples=2)
        n = _lower_for_cuda(monkeypatch, lambda p: fit_value_and_grad(
            p, scene, cam, cfg, target), params)
    assert n == (1 if what == "forward" else 2)


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    from ray_tracer_fragment_shader_tpu.utils import cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_cache_dir_default_is_in_checkout(monkeypatch):
    from ray_tracer_fragment_shader_tpu.utils import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert path == cache.default_cache_dir()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_chip_smoke_fails_without_gpu(argv, capsys):
    sys.path.insert(0, REPO)
    import chip_smoke
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_chip_smoke_four_selects_only_its_phase():
    sys.path.insert(0, REPO)
    import chip_smoke
    assert chip_smoke.select_phases(True) == ("sharded",)
    one = chip_smoke.select_phases(False)
    assert "sharded" not in one
    assert {"forward", "fit", "reference", "grad_bar", "cli",
            "timing"} <= set(one)
    assert set(chip_smoke.PHASES) == set(one) | {"sharded"}


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_png_round_trip(tmp_path):
    from ray_tracer_fragment_shader_tpu.io.image import (read_png, to_uint8,
                                                         write_png)
    img = np.random.RandomState(0).uniform(-0.1, 1.1, (7, 5, 3))
    path = str(tmp_path / "x.png")
    write_png(path, img)
    assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(read_png(path), to_uint8(img))


def test_dataclass_pytrees_under_jit():
    """FlatScene/Camera/FitParams are pytrees: leaves flow through jit,
    static fields are part of the tree structure, ``.replace`` works."""
    from ray_tracer_fragment_shader_tpu.diff.fit import FitParams
    scene, camcfg, cfg = presets.fit_target(size=8)
    cam = Camera.from_config(camcfg, 8, 8)
    params = FitParams.from_scene(scene)

    @jax.jit
    def f(scene, cam, params):
        assert scene.chain_exact is True          # static, a Python bool
        moved = params.replace(sph_center=params.sph_center + 1.0)
        return moved.into_scene(scene), cam.replace(eye=cam.eye * 2.0)

    s2, c2 = f(scene, cam, params)
    np.testing.assert_allclose(np.asarray(s2.sph_center),
                               np.asarray(scene.sph_center) + 1.0)
    np.testing.assert_allclose(np.asarray(c2.eye), np.asarray(cam.eye) * 2)
    assert s2.checker_mats == scene.checker_mats
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    assert all(hasattr(x, "shape") for x in leaves)
    assert jax.tree_util.tree_unflatten(treedef, leaves).chain_exact
    with pytest.raises(Exception):
        scene.sph_radius = None                   # frozen
    flipped = scene.replace(chain_exact=False)
    assert (jax.tree_util.tree_structure(flipped)
            != jax.tree_util.tree_structure(scene))
