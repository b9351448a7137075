"""Test configuration: CPU backend with 8 virtual devices, x64 enabled.

Multi-device sharding tests run on a virtual 8-device CPU mesh
(``--xla_force_host_platform_device_count=8``); physics oracles run in
float64.  ``NBODY_TEST_GPU=1`` skips the forced-CPU setup, for the
card-only tier (``-m gpu``, tests/test_gpu_smoke.py) on a GPU host.
"""
import os

if not os.environ.get("NBODY_TEST_GPU"):
    import re

    os.environ["JAX_PLATFORMS"] = "cpu"
    # REWRITE any inherited device-count flag: the sharded tier is
    # written for exactly 8 devices, and a leftover =4 from another
    # project's shell profile would silently change the mesh
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   os.environ.get("XLA_FLAGS", ""))
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("NBODY_TEST_GPU"):
    # also pin the live config, in case jax was configured before this
    # file set the environment
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
