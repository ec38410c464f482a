"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding (tiles x samples mesh axes) is validated with
`--xla_force_host_platform_device_count=8` on the CPU backend, because CI
has no accelerator (SURVEY.md §4(d)). ``JAX_PLATFORMS`` defaults to
``cpu`` here, so the tests stay on the CPU even where a GPU is present.

Tests marked ``gpu`` need the card; their ``gpu_device`` fixture skips
them elsewhere. On a GPU machine run them with
``JAX_PLATFORMS=cuda python -m pytest -o addopts= -m gpu tests/`` (one process,
so one JAX client holds the card).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

from pathtrace_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: repeat test runs skip XLA recompiles (keyed
# by HLO hash, so code changes invalidate exactly what they touch). One
# subdirectory per xdist worker: the cache writes its entries without a
# lock, so concurrent workers must not share them.
enable_compile_cache(f"tests_{os.environ.get('PYTEST_XDIST_WORKER', 'gw0')}")

import numpy as np
import pytest

from pathtrace_tpu import Camera, RenderConfig, cornell_box


@pytest.fixture(scope="session")
def scene():
    return cornell_box()


@pytest.fixture(scope="session")
def camera():
    return Camera.create()


@pytest.fixture(scope="session")
def tiny_cfg():
    """BASELINE config #1: 64x64, 1 spp, 2 bounces, jnp backend."""
    return RenderConfig(width=64, height=64, spp=1, max_bounces=2, backend="jnp")


@pytest.fixture(scope="session")
def small_cfg():
    return RenderConfig(width=64, height=64, spp=4, backend="jnp")


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -o addopts= -m gpu)")
    return jax.devices()[0]
