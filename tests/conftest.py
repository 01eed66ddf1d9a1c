"""Test configuration: run on the CPU with 8 virtual devices.

The analog of the reference CI running the same test binary under both
``./testbin/test`` and ``mpirun -np 4`` (``.travis.yml:25-26``): multi-device
behavior is exercised on a virtual 8-device CPU mesh.

``JAX_PLATFORMS`` picks another platform: tests marked ``chip`` need an
NVIDIA GPU and run with ``JAX_PLATFORMS=cuda python -m pytest tests -m
chip``; elsewhere they skip.
"""

import os
import sys

# Must happen before jax initializes its backends.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA GPU")
    config.addinivalue_line("markers", "slow: long-running")
