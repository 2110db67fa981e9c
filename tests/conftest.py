"""Test configuration: CPU with 8 virtual devices for sharding tests.

Sharding correctness is validated on a virtual 8-device CPU mesh exactly as
`__graft_entry__.py`'s dryrun does. The suite runs on the CPU unless
JAX_PLATFORMS says otherwise: on a machine with a CUDA GPU,
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu` runs the tests that
need the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

# JAX reads JAX_PLATFORMS when it is first imported; a plugin imported
# before this file may have done so already, so set the platforms through
# the config API as well (must happen before any computation runs).
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first CUDA device, for tests marked `gpu`. They skip where JAX
    has no GPU; `python chip_smoke.py` runs the same checks on the card."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this check on "
                    "the card")
    return gpus[0]
