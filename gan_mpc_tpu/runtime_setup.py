"""Process-level runtime configuration: JAX's persistent compile cache.

Called by the runner entry points. A later process that compiles the same
program at the same shapes loads it from the cache instead.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is set
  here.
* Otherwise the cache is ``<checkout>/.jax_cache``. The path is fixed
  because it is part of the cache key: a directory that moves never hits.
* On the CPU backend the cache stays off unless
  ``GAN_MPC_TPU_FORCE_COMPILE_CACHE`` is set: jaxlib 0.9's CPU executable
  (de)serialization aborts intermittently (observed in
  compilation_cache get/put).
"""

from __future__ import annotations

import os
from typing import Mapping

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)

_DONE = False


def cache_dir_for(backend: str, environ: Mapping[str, str] = os.environ):
    """The directory this process should point JAX's cache at, or None
    when there is nothing to set."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if backend == "cpu" and not environ.get("GAN_MPC_TPU_FORCE_COMPILE_CACHE"):
        return None
    return CACHE_DIR


def setup() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    path = cache_dir_for(jax.default_backend())
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
