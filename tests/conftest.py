"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's sw_emu flow (SURVEY.md section 4): the same device
code runs on the CPU backend, so tests are fast and deterministic and the
test workers never open a GPU; `chip_smoke.py` exercises the card.
"""
import os

# Must be set before jax import: the CPU backend, with 8 virtual devices
# for the mesh tests.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices for mesh tests"


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Drop compiled programs between test modules: XLA:CPU's JIT has
    crashed after accumulating many large compiled programs in one
    process."""
    yield
    jax.clear_caches()
