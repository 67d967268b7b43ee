"""Test configuration.

Runs JAX on a virtual 8-device CPU platform unless ``JAX_PLATFORMS`` says
otherwise, so sharding tests exercise real multi-device code paths on any
host.  Must run before the first ``import jax`` anywhere in the test
session.  Tests marked ``gpu`` take the ``gpu_device`` fixture, which skips
them when JAX finds no GPU; run them on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import json
import pathlib

import pytest

from pvac_hfhe_cppbyv_tpu.config import enable_compile_cache

enable_compile_cache()

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU JAX finds; skips the test when there is none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX finds no gpu backend)")


@pytest.fixture(scope="session")
def vectors():
    with open(GOLDEN / "vectors.json") as f:
        return json.load(f)


@pytest.fixture(scope="session")
def golden_small():
    return GOLDEN / "small"


@pytest.fixture(scope="session")
def small_keys():
    """Fresh small-params keypair shared across scheme tests."""
    import pvac_hfhe_cppbyv_tpu as pvac

    pk, sk = pvac.keygen(pvac.small_test_params())
    return pk, sk


@pytest.fixture(scope="session")
def golden_default():
    return GOLDEN / "default"
