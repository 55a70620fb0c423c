"""Where JAX keeps its persistent compilation cache.

A compiled render program is keyed on the cache directory among other
things, so the directory must not move between runs.  When the
``JAX_COMPILATION_CACHE_DIR`` environment variable is set, JAX reads it
itself and nothing else is set here; otherwise the cache goes to one fixed
directory inside the checkout (``.jax_cache``, listed in ``.gitignore``).
"""

from __future__ import annotations

import os
import pathlib

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
