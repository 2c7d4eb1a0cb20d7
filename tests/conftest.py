"""Test configuration: run on CPU with 8 virtual devices so the multi-device
sharding paths are exercised without a GPU (SURVEY.md §4).

jax.config.update is used as well as JAX_PLATFORMS, in case jax was
imported before the variable was read.  Tests marked ``gpu`` need a card:
the ``gpu_device`` fixture skips them here, deciding at run time.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# CPU unless JAX_PLATFORMS names another platform (``JAX_PLATFORMS=cuda``
# for the ``gpu``-marked tests on a card)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX found none.  Decided when
    the test runs, never at import, so every worker collects the same
    tests."""
    from gmres_tpu import backend

    dev = backend.describe_devices()
    if dev["platform"] != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev['platform']}")
    return jax.devices()[0]
