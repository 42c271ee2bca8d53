"""Test harness: force an 8-virtual-device CPU JAX so sharding semantics are
testable without several cards, and enable x64 so golden comparisons against
SciPy are exact. Tests that need an NVIDIA card carry the `gpu` marker and
take the `gpu` fixture, which skips them here; chip_smoke.py runs what they
cover on the card."""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a CUDA GPU. Decided here, when the test runs,
    never at import: every xdist worker must collect the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
