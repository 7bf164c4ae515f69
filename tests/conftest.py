"""Test configuration: run everything on a virtual 8-device CPU mesh.

This is the TPU-native analog of a fake distributed backend (the reference
has none, SURVEY.md §4): all sharding/collective paths are exercised on
XLA:CPU with 8 virtual devices so multi-chip programs compile and execute
without TPU hardware.

Must set the environment BEFORE jax is imported anywhere.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# The env var alone does not stick in this environment (an external plugin
# platform is pre-selected); the config update reliably forces CPU.
jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_enable_x64", False)

# Persistent compile cache: the suite re-compiles the same programs every
# run; on the 1-core host the compile time dominates the 50-min suite.
from vistracker_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
# Parity tests compare against torch fp32; the backend default matmul
# precision is bf16 even on CPU, so pin fp32 for the test session.
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
