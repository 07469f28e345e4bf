"""JAX persistent compilation cache location, shared by every entry point
(the CLI, bench.py, chip_smoke.py)."""

from __future__ import annotations

import os
from pathlib import Path

#: fixed default: the cache key includes the path, so it must not move
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jaxcache"


def enable_compile_cache() -> str:
    """Keep compiled programs in JAX_COMPILATION_CACHE_DIR when it is set,
    otherwise in <checkout>/.jaxcache. Returns the directory used."""
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache
