"""Test harness configuration.

Tests run on the JAX CPU backend with 8 virtual devices so the sharded
(shard_map / psum) paths are exercised without several cards
(SURVEY.md §4.3).  Must run before any ``import jax`` in the test tree.
Tests marked ``chip`` need a GPU; the ``gpu`` fixture skips them here.
"""

import os
import sys

import pytest

# ``JAX_PLATFORMS=cuda,cpu pytest -m chip`` runs the card-only tests
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

assert len(jax.devices("cpu")) == 8, \
    f"expected 8 virtual CPU devices, got {jax.devices('cpu')}"

# make the repo root importable regardless of pytest rootdir
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running (multi-process) tests")
    config.addinivalue_line(
        "markers", "chip: needs a GPU; run on the card with `pytest -m chip`")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (JAX finds none)")
    return devs[0]
