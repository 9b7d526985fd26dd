"""JAX's persistent compilation cache for the entry-point scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache directory and JAX
reads it itself; otherwise the cache lives in ``<checkout>/.jax_cache``.
The directory is part of the cache key, so it is derived from this file's
location rather than from the working directory.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory ``enable_compile_cache`` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on for every compile of this process and
    return its directory. Call once, before the first compile."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
