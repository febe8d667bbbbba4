"""JAX's persistent compilation cache, set up the same way by every entry
point (the CLI, ``bench.py``, ``chip_smoke.py``, the tests and the tools).

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads the variable
itself and this module sets no directory. Otherwise the cache lives at a
fixed path inside the checkout (``<repo>/.jax_cache``, git-ignored); the
path is part of the cache key, so a fixed one is what lets reruns hit.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on for every compiled program; returns the
    directory it writes to. Call before the first compilation."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir
