"""Test configuration: run on the CPU backend with 8 virtual devices.

Mirrors the SURVEY.md §4 strategy: per-op golden tests against numpy
references, plus multi-device sharding tests via
``--xla_force_host_platform_device_count`` (the capability the reference
lacks entirely — it requires a real OpenCL device).

The CPU is forced even where a GPU is present, so the suite means the same
everywhere. ``ICP_TEST_DEVICE=gpu`` leaves the platform alone instead:
that is how the ``gpu``-marked tests run on the card
(``ICP_TEST_DEVICE=gpu python -m pytest -m gpu tests/``; chip_smoke.py
runs them too). Must set the env vars BEFORE jax initializes a backend.
"""

import os

ON_GPU = os.environ.get("ICP_TEST_DEVICE") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    """--profiling: per-op CPU-vs-accelerated timing, mirroring the
    reference's test flag (src/ICP/tests/helper_funcs.cpp:66-75)."""
    parser.addoption("--profiling", action="store_true", default=False,
                     help="print per-op timing comparisons")


@pytest.fixture
def profiling(request):
    return request.config.getoption("--profiling")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided here, at test time,
    never at import: every xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with ICP_TEST_DEVICE=gpu "
                    "on the card")
