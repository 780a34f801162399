"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the rebuild test strategy (SURVEY.md §4): the dense oracle renderer
runs on CPU so kernel-vs-oracle and gradient tests need no accelerator
(the tile kernel runs in the Pallas interpreter), and multi-chip sharding
is validated with XLA's host-platform device virtualization.

Tests marked `gpu` need a card; they skip on the CPU (see the `gpu`
fixture). On a GPU machine run them with

    GSVC_TEST_GPU=1 python -m pytest tests/ -m gpu

(chip_smoke.py does). GSVC_TEST_GPU=1 leaves JAX's platform alone instead
of forcing the CPU.
"""

import os

import pytest

if not os.environ.get("GSVC_TEST_GPU"):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

import jax  # noqa: E402

from gsvc_tpu.platform import configure  # noqa: E402

jax.config.update("jax_enable_x64", False)
configure()


@pytest.fixture
def gpu():
    """The first device, or skip when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            "needs a GPU: run `GSVC_TEST_GPU=1 python -m pytest tests/ -m gpu`"
            " on the card"
        )
    return dev
