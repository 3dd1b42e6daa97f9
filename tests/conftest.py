"""Test configuration: the suite runs on XLA's CPU backend with 8 virtual
devices, so sharding paths are exercised without a card.  This must run
before any jax backend initialization.

MODIMIZER_TEST_GPU=1 leaves the platform to JAX instead: that is how
``python chip_smoke.py`` runs the tests marked ``gpu`` on the card.  Card
presence is decided by the ``gpu`` fixture at run time, never here, so
every xdist worker collects the same tests.
"""

import os
import sys

import pytest

_ON_GPU = os.environ.get("MODIMIZER_TEST_GPU") == "1"
if not _ON_GPU:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8"
                               ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not _ON_GPU:
    # a pytest plugin may have imported jax before this file ran
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import modimizer  # noqa: E402,F401  (enables x64)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is an NVIDIA GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run python chip_smoke.py on the "
                    "card")
