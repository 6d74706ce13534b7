"""Persistent XLA compilation cache.

JAX's persistent compilation cache serializes compiled executables to disk
keyed by (program, backend, flags), so a later process with the same
programs loads them instead of compiling. One knob decides where it lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and this module
  sets no other directory;
* otherwise: ``<checkout>/.jax_cache``, a fixed path inside the checkout
  (listed in ``.gitignore``), so the cache key's path never moves.

``enable_compile_cache()`` is called by the CLI, ``bench.py`` and
``chip_smoke.py`` on startup; library users opt in explicitly.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
