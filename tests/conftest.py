"""Test harness: run everything on the CPU with 8 virtual devices so the same
Mesh/shard_map code paths that run on several GPUs are exercised without
hardware (SURVEY.md section 4, test strategy item 3).  The Pallas kernels run
in the Pallas interpreter (``interpret=True``); what needs the card itself is
marked ``gpu`` and skips here (``chip_smoke.py`` runs it on the card).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


@pytest.fixture
def rng():
    return np.random.RandomState(0)
