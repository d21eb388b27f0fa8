"""Persistent compilation cache for the repository's scripts.

The library never sets a cache on import.  Scripts (`chip_smoke.py`,
`bench.py`, `__graft_entry__.py`) call :func:`enable_compile_cache` once,
before their first compilation.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(repo_root: str) -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it on
    its own, so nothing else is set); otherwise point JAX's persistent
    cache at the fixed directory ``<repo_root>/.jax_cache``.  The path is
    part of the cache key, so it never depends on a temporary name, the
    process id or the time.  Returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = os.path.join(os.path.abspath(repo_root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
