"""Test harness: force CPU with an 8-device virtual mesh and float64.

Tests run the device code paths on a virtual CPU mesh (the multi-GPU path
runs through ``chip_smoke.py --devices 4``); float64 is enabled so golden
comparisons against the NumPy oracle are tight.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# The config knob wins over any platform choice made before import.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
