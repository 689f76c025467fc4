"""Tracing / profiling.

The reference's only instrumentation is commented-out per-pixel couts
(Hw4/MySdlApplication.cpp:1317-1318).  Equivalents here: named scopes
for the forward/backward/collective phases, jax.profiler trace capture, and
a rays/s meter (SURVEY.md section 5)."""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def named_phase(name: str) -> Iterator[None]:
    """Annotate a trace region (shows up in profiler timelines)."""
    with jax.named_scope(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler device trace into log_dir."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class RaysMeter:
    """Throughput meter for the BASELINE metric (rays/s/chip)."""

    def __init__(self, rays_per_step: int, n_chips: Optional[int] = None):
        self.rays_per_step = rays_per_step
        self.n_chips = n_chips or jax.device_count()
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1) -> None:
        self._steps += n

    @property
    def rays_per_s(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps * self.rays_per_step / max(dt, 1e-9)

    @property
    def rays_per_s_per_chip(self) -> float:
        return self.rays_per_s / self.n_chips
