"""Test configuration: run on CPU with 8 virtual devices so the distributed
(mesh/shard_map) paths are exercised without accelerator hardware —
first-class automated distributed testing (improves on the reference, whose
multi-rank coverage was manual-only; SURVEY.md §4).

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere. On a machine
with a card, run them with ``JAX_PLATFORMS=cuda python -m pytest tests -m
gpu``; `chip_smoke.py` runs the same checks at full size.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on any other backend")


@pytest.fixture(autouse=True)
def _skip_without_gpu(request):
    # decided per test, at run time: every xdist worker collects the same
    # tests whatever the machine has
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX backend is {jax.default_backend()!r}")


@pytest.fixture
def rng():
    return np.random.default_rng(42)
