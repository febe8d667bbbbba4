"""Test configuration: an 8-virtual-device CPU backend so multi-device
sharding paths compile and run without accelerator hardware.

The tests run on the CPU unless ``JAX_PLATFORMS`` names others: the
``gpu``-marked tests need ``JAX_PLATFORMS=cuda,cpu`` on a machine with the
card, and skip everywhere else.
"""

import os

# must be set before jax initializes its backends
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from nvsf_tpu.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", False)
enable_compile_cache()

assert len(jax.devices("cpu")) == 8, "expected 8 virtual CPU devices"
