"""Test configuration: force an 8-device virtual CPU mesh.

Tests must run anywhere (CI, dev boxes) and must exercise the multi-device
sharding path, so they run on the CPU backend with 8 virtual devices.
The GPU runs chip_smoke.py, the device tier in tests_gpu/ and bench.py.
``jax.config`` is set here as well as ``JAX_PLATFORMS``, so the override
holds even if JAX was imported before this file, as long as no backend has
been initialized yet.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", (
    "tests require the CPU backend; another backend was already initialized "
    "before conftest ran"
)
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices for sharding tests"
