"""Test configuration.

Tests run on a virtual 8-device CPU mesh so that sharding/`shard_map` paths are
exercised without real multi-device hardware (``chip_smoke.py --four-cards``
runs the same paths on four GPUs).  JAX backends are initialised lazily, so
setting ``jax_platforms`` to ``cpu`` here (before any `jax.devices()` call) is
sufficient.

A test that needs a CUDA device carries the ``gpu`` marker and skips from
inside a fixture or the test body when there is none — never at import time,
so every pytest-xdist worker collects the same tests.  None needs one today:
``chip_smoke.py`` covers the device path on the GPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: many tests build fresh Solver objects whose
# jitted programs have IDENTICAL HLO (e.g. finite-difference reference loops
# construct one Solver per sample).  Without this, each instance recompiles
# from scratch — tens of seconds per compile on a small CI host.
from sunode_tpu.utils.compile_cache import use_checkout_cache  # noqa: E402

use_checkout_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

