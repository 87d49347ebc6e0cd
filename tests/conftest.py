"""Test harness configuration.

Tests run on CPU with 8 virtual XLA devices so multi-chip sharding logic
(mesh over the DB axis etc.) is exercised without accelerators — the standard
JAX pattern for testing distributed code on one host. Must be set before the
first jax import anywhere in the test process.
"""

import os

# CPU unless the caller names a platform: `JAX_PLATFORMS=cuda pytest -m gpu`
# runs the card-only tests on a GPU machine
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tiresias_tpu.config import DspConfig  # noqa: E402


@pytest.fixture(scope="session")
def dsp() -> DspConfig:
    return DspConfig()


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(1234)
