"""Where compiled XLA executables persist between processes.

A cold compile of the full pipeline takes minutes; the persistent cache
turns every later process's compile into a load. JAX reads
`JAX_COMPILATION_CACHE_DIR` itself when it is imported, so where that
variable is set the program sets no directory of its own. Otherwise the
cache lives at a fixed path inside the checkout (`.jax_cache`, listed in
`.gitignore`): the path is part of the cache key, so it must not move.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
