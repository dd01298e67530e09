"""Test config: run JAX on a virtual 8-device CPU mesh so multi-device
sharding paths are exercised without accelerators.

The platform defaults to the CPU; the GPU-only tests (marker `gpu`) run
on a machine with a card under
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test,
    never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m "
                    "pytest -m gpu tests/")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def zipf(rng, n, alpha=1.0, sigma=1 << 12):
    """Quick zipf-ish sampler for test inputs (not the reference RNG)."""
    ranks = np.arange(1, sigma + 1)
    p = 1.0 / ranks.astype(np.float64) ** alpha
    p /= p.sum()
    return rng.choice(sigma, size=n, p=p).astype(np.uint32)


@pytest.fixture(scope="session")
def datasets(rng):
    """Small fixed-seed inputs covering the interesting regimes."""
    return {
        "zipf12": zipf(rng, 20000, 1.0, 1 << 12),
        "zipf_large": (zipf(rng, 20000, 1.2, 1 << 18) * 977).astype(np.uint32),
        "geometric": rng.geometric(0.3, size=20000).astype(np.uint32) - 1,
        "uniform_small": rng.integers(0, 300, size=20000).astype(np.uint32),
        "wide": rng.integers(0, 1 << 28, size=5000).astype(np.uint32),
        "tiny": np.array([5, 5, 5, 1, 2, 3, 5, 5, 900, 70000, 5, 5, 1 << 19],
                         dtype=np.uint32),
        "single_sym": np.full(1000, 42, dtype=np.uint32),
    }
