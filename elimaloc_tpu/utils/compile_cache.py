"""JAX persistent compilation cache for the entry points.

Compiling a fused replay takes tens of seconds per configuration, so the
entry points (``chip_smoke.py``, ``bench.py``, ``python -m elimaloc_tpu.cli``)
keep compiled programs on disk. ``JAX_COMPILATION_CACHE_DIR``, when set,
places the cache and JAX reads it itself. Otherwise the cache lives at a
fixed directory inside the checkout: the path is part of what a later run
must find again, so it is never derived from a temporary name, a pid or the
time.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def cache_dir_to_set() -> str | None:
    """The directory this program must configure, or None when the
    environment already names one (JAX then uses it unaided)."""
    return None if os.environ.get(ENV_VAR) else DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    path = cache_dir_to_set()
    if path is None:
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", path)
    return path
