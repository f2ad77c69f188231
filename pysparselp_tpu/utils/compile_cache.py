"""Persistent XLA compile cache location for the repository's entry scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing else is touched
(JAX reads it itself).  Otherwise the cache goes to a fixed directory inside
the checkout, so a later process on the same checkout finds what an earlier
one compiled: the cache key includes the path, so it must never come from a
temporary name, a pid or the time.
"""

from __future__ import annotations

import os

CACHE_DIRNAME = ".jax_cache"


def configure_compile_cache(root) -> str:
    """Point JAX's persistent compile cache at ``<root>/.jax_cache`` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(os.path.abspath(root), CACHE_DIRNAME)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
