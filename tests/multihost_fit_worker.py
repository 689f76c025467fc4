"""Worker process of tests/test_parallel.py::test_multihost_init_two_processes.

Each of the two spawned processes brings up ``jax.distributed`` via
``initialize_multihost`` (the one code path that differs between the
single-host CPU dryrun and a multi-host run — VERDICT r4 weak #4),
contributes 2 virtual CPU devices to a 4-device global mesh, and runs ONE
sharded kernel-path fit step (``make_sharded_fit_step_pallas``, kernels in
interpret mode).  The loss is
psum'd over the global mesh, so every process prints the same globally
reduced value; the parent asserts it equals the single-process loss.

Usage: python multihost_fit_worker.py <process_id> <num_processes> <port>
"""
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from ray_tracer_fragment_shader_tpu.parallel.multihost import (  # noqa: E402
    initialize_multihost)

initialize_multihost(coordinator_address=f"localhost:{port}",
                     num_processes=nproc, process_id=pid)
assert len(jax.devices()) == 2 * nproc, jax.devices()
assert len(jax.local_devices()) == 2

import numpy as np  # noqa: E402
import optax  # noqa: E402

from ray_tracer_fragment_shader_tpu.core.renderer import render_image  # noqa: E402
from ray_tracer_fragment_shader_tpu.diff.fit import (  # noqa: E402
    FitParams, make_sharded_fit_step_pallas)
from ray_tracer_fragment_shader_tpu.ops.rays import Camera  # noqa: E402
from ray_tracer_fragment_shader_tpu.parallel.mesh import make_mesh  # noqa: E402
from ray_tracer_fragment_shader_tpu.scene import presets  # noqa: E402

SIZE = 32
scene, camcfg, cfg = presets.fit_target(size=SIZE)
cam = Camera.from_config(camcfg, SIZE, SIZE)
# deterministic and identical on every process (same program, same backend)
target = np.asarray(render_image(scene, cam, cfg))

params = FitParams.from_scene(scene).replace(
    sph_center=scene.sph_center + 0.5)
opt = optax.adam(0.05)
state = opt.init(params)

mesh = make_mesh(jax.devices())  # spans both processes
step, tgt = make_sharded_fit_step_pallas(scene, cam, cfg, target, opt, mesh,
                                         interpret=True)
params, state, loss = step(params, state, tgt)
print(f"MULTIHOST_LOSS {float(loss):.10g}", flush=True)
