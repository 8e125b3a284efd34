"""Test configuration: run everything on CPU with 8 virtual devices.

Multi-device logic (shard_map + ppermute ghost exchange) is tested without cards by
forcing the host platform and splitting it into 8 fake devices, per SURVEY.md §4.
``XLA_FLAGS`` works because backends initialize lazily (no ``jax.devices()`` call can
have happened before conftest import).  Pallas kernels run here only where a test
passes ``interpret=True``.

Tests that need a GPU carry the ``gpu`` marker and skip here (a fixture decides);
what they check runs on the card as a phase of ``chip_smoke.py``.

The persistent compile cache is off in tests: entry points under test (the CLI)
turn it on for real runs, and test workers should not share compiled entries.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)
assert jax.devices()[0].platform == "cpu", "tests must run on the virtual CPU mesh"
assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
