"""JAX's persistent compilation cache for scripts run from a source checkout.

The library itself sets no cache.  Entry points (``chip_smoke.py``,
``bench.py``, the test configuration, ``scripts/``) call
:func:`use_checkout_cache` before their first compile:

* if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that directory
  and nothing is changed;
* otherwise the cache goes to ``<checkout>/.jax_cache`` — a fixed path,
  since the path is part of the cache key and a moving directory never hits.
"""

from __future__ import annotations

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def use_checkout_cache() -> str:
    """Point JAX's compilation cache at ``<checkout>/.jax_cache`` unless
    ``JAX_COMPILATION_CACHE_DIR`` names one; returns the directory in use."""
    env_dir = os.environ.get(CACHE_ENV)
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
