"""JAX persistent compilation cache for the command-line entry points.

``bench.py``, ``chip_smoke.py`` and ``tools/quality.py`` call
``enable_compile_cache()`` once at start-up; library code and tests never
do. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is changed here. Otherwise the cache lives at a fixed directory
inside the checkout, so a second run of the same shapes finds its
compiled programs again.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
