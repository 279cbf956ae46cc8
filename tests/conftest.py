"""Test env: force the CPU backend with 8 virtual devices so sharding tests
run on any host (SURVEY.md §4 "multi-node without a cluster").

The platform override goes through ``jax.config`` before any backend
initializes.  The checks that need a GPU (the walk kernel compiled for the
card against the gather walk, the goldens and the bench frame on the card)
live in ``chip_smoke.py``, not here.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def assets_dir():
    """The Cornell meshes shipped with the package (RT_ASSETS overrides)."""
    from ray_tracer_tpu.scene import presets

    return presets.DEFAULT_ASSETS


@pytest.fixture
def rand():
    return np.random.default_rng(1234)
