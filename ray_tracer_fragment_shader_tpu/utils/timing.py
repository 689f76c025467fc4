"""Device timing and device identification for the measurement scripts
(``bench.py``, ``chip_smoke.py``, ``parallel/multihost.py``).

Times are host-clock intervals around calls that end in
``jax.block_until_ready``, so each one covers the device work of the call;
the first call (compilation) is excluded as warm-up.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict

import jax


def median_time(fn: Callable[[], object], iters: int = 20,
                warmup: int = 1) -> Dict[str, object]:
    """Median wall time of ``fn()`` (a zero-arg callable returning JAX
    values) over ``iters`` calls after ``warmup`` calls.  Returns
    dict(median_s, min_s, max_s, times_s, warmup_s)."""
    if iters < 1:
        raise ValueError("iters must be >= 1")
    t0 = time.perf_counter()
    for _ in range(warmup):
        jax.block_until_ready(fn())
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    ordered = sorted(times)
    return dict(median_s=ordered[len(ordered) // 2], min_s=ordered[0],
                max_s=ordered[-1], times_s=times, warmup_s=warmup_s)


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the machine's cards,
    one line per card (the card's name and power limit belong beside every
    number measured on it)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    """The devices of a measurement run; raises unless JAX's platform is
    ``gpu`` (a measurement never falls back to the CPU)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's platform is "
                           f"{devices[0].platform!r}")
    return devices
