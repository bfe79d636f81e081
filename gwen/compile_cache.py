"""Persistent XLA compile cache location (one helper for every entry point).

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here. Otherwise the cache goes to the fixed path ``<checkout>/.jax_cache``
(listed in ``.gitignore``): a fixed path, because the cache key includes it
and a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[1]


def cache_dir() -> Path:
    """The directory the compile cache lives in."""
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else CHECKOUT / ".jax_cache"


def enable_compile_cache() -> Path:
    """Point JAX's persistent compile cache at :func:`cache_dir`; returns
    it. Sets nothing when the environment variable names the directory."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", str(path))
    return path
