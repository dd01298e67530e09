"""Process-level runtime setup: the persistent compilation cache."""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                         os.pardir, ".jax_cache"))


def enable_compilation_cache() -> None:
    """Persistent XLA compilation cache, so repeat runs skip compiling.
    Where JAX_COMPILATION_CACHE_DIR is set, JAX already keeps its cache
    there and no directory is set here; otherwise the cache lives at the
    fixed <repo>/.jax_cache (a fixed path, so entries are found again)."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

