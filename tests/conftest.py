"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device collectives (jit/shard_map) are exercised without an
accelerator via 8 virtual CPU devices (SURVEY §4 implication). Tests that
need the GPU are marked ``gpu`` and take the ``gpu`` fixture, which skips
them elsewhere; on the card run them with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

import jax
import numpy as np
import pytest

from gwen.compile_cache import enable_compile_cache

# The CPU unless the environment names a platform: the gpu-marked tests
# run on the card with JAX_PLATFORMS=cuda.
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)
# The suite is compile-bound; the persistent compile cache (one location
# for every entry point, see gwen.compile_cache) cuts repeat runs to
# the actual test work.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
