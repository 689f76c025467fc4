"""Multi-host initialization and the scaling-efficiency harness.

The reference has zero networking (SURVEY.md 2.3); the scaling story here
is: ``jax.distributed.initialize()`` on every host, one global 1-D mesh over
all devices, pixel tiles sharded, scene replicated, gradients reduced with
one ``psum``.  The same SPMD code runs per-host — there are no per-rank code
paths, so the 8-virtual-device CPU tests exercise exactly the code that
runs on several cards.
"""
from __future__ import annotations

from typing import List, Optional

import jax
import numpy as np


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """jax.distributed bring-up (no-op on a single process).  Pass the
    coordinator address (``host:port``), process count and process id
    explicitly."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)


def scaling_sweep(scene, camera, config, mesh_sizes: Optional[List[int]] = None,
                  iters: int = 4, backend: str = "pallas",
                  interpret: Optional[bool] = None):
    """Strong-scaling sweep of the sharded fwd+bwd step over growing mesh
    sizes.  Returns a list of dicts (n, step_time_s, rays_per_s, efficiency
    vs the smallest mesh).  Efficiency numbers are only meaningful on real
    multi-chip hardware; on a virtual CPU mesh this validates structure, not
    speed (the 'devices' share one host's cores).

    ``backend="pallas"`` (default) sweeps the kernel path — per-band
    two-phase kernels with psum'd grads; ``backend="core"`` the XLA
    renderer under autodiff.  Each step time is the median of ``iters``
    calls ended by ``block_until_ready`` (utils/timing.py)."""
    import jax.numpy as jnp
    import optax

    from ..diff.fit import (FitParams, make_sharded_fit_step,
                            make_sharded_fit_step_pallas)
    from ..parallel.mesh import make_mesh
    from ..parallel.shard import render_image_sharded
    from ..utils.timing import median_time

    devices = jax.devices()
    if mesh_sizes is None:
        mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32)
                      if n <= len(devices)]

    rows = []
    base_rate = None
    for n in mesh_sizes:
        mesh = make_mesh(devices[:n])
        target = render_image_sharded(scene, camera, config, mesh,
                                      backend=backend, interpret=interpret)
        opt = optax.adam(0.05)
        params = FitParams.from_scene(scene)
        state = opt.init(params)
        if backend == "pallas":
            step, tgt = make_sharded_fit_step_pallas(
                scene, camera, config, target, opt, mesh,
                interpret=interpret)
            args = (tgt,)
        else:
            tgt_flat = jnp.reshape(target, (-1, 3))
            pad = (-tgt_flat.shape[0]) % n
            if pad:
                tgt_flat = jnp.concatenate(
                    [tgt_flat, jnp.tile(tgt_flat[-1:], (pad, 1))], 0)
            step, (ii, jj) = make_sharded_fit_step(scene, camera, config,
                                                   tgt_flat, opt, mesh)
            args = (ii, jj, tgt_flat)
        timing = median_time(lambda: step(params, state, *args),
                             iters=iters)
        dt = timing["median_s"]
        loss = step(params, state, *args)[2]
        rate = config.width * config.height / dt
        if base_rate is None:
            base_rate = rate / n  # per-device rate on the smallest mesh
        rows.append(dict(n=n, step_time_s=dt, rays_per_s=rate,
                         efficiency=rate / (base_rate * n),
                         loss=float(loss)))
    return rows
