"""Persistent XLA compilation cache for the repository's entry points.

``chip_smoke.py``, ``bench.py`` and the CLI call ``enable_compile_cache``
before their first compile.  When ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX reads it itself and this module sets no directory; otherwise the
cache lives at ``<repo>/.jax_cache``, a fixed path, so every run in this
checkout finds what an earlier run compiled.  Every program is kept, not
only those that took JAX's default one second to compile: most fleet
steps compile in about a second on the GPU.
"""

from __future__ import annotations

import os
import pathlib

__all__ = ["REPO_CACHE_DIR", "enable_compile_cache"]

REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(REPO_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
