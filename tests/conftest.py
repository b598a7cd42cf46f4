"""Test harness: force JAX onto a virtual 8-device CPU mesh.

The suite runs on the CPU; sharding correctness is validated on
``xla_force_host_platform_device_count=8`` CPU devices.  Must run before jax
imports.  Tests that need a GPU carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them here; ``chip_smoke.py`` runs them on the
card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# The jaxtyping pytest plugin imports jax before this conftest runs, so the
# env var above can be read too late — force the config directly (the backend
# itself is not initialized until first use, so this still takes effect).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at import time, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run by chip_smoke.py on the card")


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)


def sine_wave(freq: float, rate: float, count: int, amp: float = 1.0) -> np.ndarray:
    """Test fixture signal (mirrors reference util/audio.rs:29-33 semantics)."""
    n = np.arange(count, dtype=np.float32)
    return (np.sin(2.0 * np.pi * freq * n / rate) * amp).astype(np.float32)
