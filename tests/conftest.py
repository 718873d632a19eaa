"""Test config: run JAX on a virtual 8-device CPU mesh (no GPU needed).

The platform is JAX_PLATFORMS when set (`JAX_PLATFORMS=cuda pytest -m gpu`
runs the tests that need the card on it), else the CPU. jax.config.update
pins it even when a GPU plugin is installed; it works at any point
before first backend use.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
platform = os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", platform)
