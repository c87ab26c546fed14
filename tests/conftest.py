"""Test configuration: a virtual 8-device CPU platform by default.

Multi-device sharding is validated on the virtual mesh; kernels are
unit-tested against scipy/sklearn and their plain references on the CPU.

Tests that need a GPU carry the `gpu` marker and skip from a fixture
when none is present (tests/test_gpu_device.py). They run on the card
in-process through `python chip_smoke.py`, which sets JAX_PLATFORMS
itself before it imports jax; this file then leaves the platform alone.
"""

import os

if "JAX_PLATFORMS" not in os.environ:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips without one (chip_smoke.py runs it)",
    )
