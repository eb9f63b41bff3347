"""Persistent XLA compile cache for the entry points (render, bench, smoke).

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives at a fixed ``.jax_cache/`` in the repo
root, so every entry point of one checkout shares it, and only on the GPU
backend: XLA:CPU's executable (de)serialization does not round-trip
host machine features and large cached CPU executables can crash on load.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def enable(backend: str | None = None) -> str | None:
    """Point JAX at the cache; returns the directory in use, or None."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if (backend or jax.default_backend()) != "gpu":
        return None
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
