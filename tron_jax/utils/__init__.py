"""Process-level helpers."""

from __future__ import annotations

import os

# the checkout's own cache directory (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already keeps its cache
    there and no other path is set; otherwise the cache goes to the fixed
    directory DEFAULT_CACHE_DIR inside the checkout."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


__all__ = ["DEFAULT_CACHE_DIR", "enable_compilation_cache"]
