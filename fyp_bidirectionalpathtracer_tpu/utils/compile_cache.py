"""JAX's persistent compilation cache, kept at one fixed place.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this sets
no other directory.  Otherwise the cache lives in `.jax_compile_cache/` at
the root of the checkout: a fixed path, because the path is part of what
the cache is keyed on, so a directory that moves never hits.
"""
from __future__ import annotations

import os

CHECKOUT_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT_DIR, ".jax_compile_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
