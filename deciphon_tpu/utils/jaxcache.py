"""Persistent XLA compilation cache setup.

The scan's programs take seconds to compile; a persistent cache lets every
process after the first load them instead.  Where JAX_COMPILATION_CACHE_DIR
is set, JAX reads it itself and no other directory is set here; otherwise
the cache lives at one fixed path inside the checkout (`build/jax_cache`,
git-ignored).  The path is part of what a cache hit needs, so it never
depends on a temporary name, a process id or the time.  Call before the
first jit execution.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "build",
    "jax_cache"))


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
