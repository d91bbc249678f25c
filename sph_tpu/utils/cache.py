"""Persistent XLA compile cache location.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set this module
leaves it alone.  Otherwise the cache goes to ``<checkout>/.jax_cache`` (a
fixed path, so a later process finds the entries again; listed in
``.gitignore``).
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory compiled programs are cached in."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`cache_dir`; returns it."""
    import jax
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
