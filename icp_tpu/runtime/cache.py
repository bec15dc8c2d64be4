"""Persistent XLA compile cache for the entry points.

Compiling the registration loop for the GPU takes seconds per shape and
configuration; a persistent cache keeps the executables (and XLA's autotuning
choices) between processes. Entry points call :func:`enable_compile_cache`
before their first compile.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it stands: JAX
    reads it itself and nothing is changed here. Otherwise the cache goes
    to the fixed ``.jax_cache/`` at the checkout root (listed in
    ``.gitignore``), so every run from the same checkout finds the entries
    of the runs before it.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
