"""Multi-device scaling: shard batches of ODE solves over a device mesh.

The reference's only parallelism is fork-per-chain multiprocessing
(README.md:233-238; quickstart_pymc.rst:154-163) — one CVODES instance per OS
process.  The JAX-native equivalent (SURVEY.md §2 "Parallelism") is:

  * ``vmap`` batches thousands of independent solves into one lockstep
    integrator on one device;
  * ``jax.sharding`` + ``jit`` shards the batch ("chains") axis across
    devices — embarrassingly parallel, no collectives in the hot loop;
  * a second mesh axis ("state") shards large vector *states* (the SIR
    1k-region family): elementwise RHS work and the adjoint checkpoint
    buffers split along the state axis, XLA inserting halo collectives for
    neighbor coupling and psums for the WRMS norms.

Because chains are independent, XLA inserts no communication for the chain
axis — the only cross-device traffic is the initial scatter and final
gather.  Meshes take devices in ``jax.devices()`` order with no topology
shape: the GPUs of one host reach each other all to all over NVLink.  This
file provides small helpers; they are plain JAX and work identically on a
virtual CPU mesh (tests) and real GPUs.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "shard_over_chains",
    "shard_batch_state",
    "CHAINS_AXIS",
    "STATE_AXIS",
]

CHAINS_AXIS = "chains"
STATE_AXIS = "state"


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = CHAINS_AXIS
) -> Mesh:
    """A 1-D device mesh over the chain/batch axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def make_mesh_2d(
    n_chains: int,
    n_state: int,
    chain_axis: str = CHAINS_AXIS,
    state_axis: str = STATE_AXIS,
) -> Mesh:
    """A 2-D (chains x state) mesh: chains stay embarrassingly parallel while
    large model states (e.g. 3R SIR compartments) split across ``n_state``
    devices, dividing both the per-device RHS work and — the usual memory
    limit — the f64 adjoint checkpoint buffer (S, 1+2n, B)."""
    devs = jax.devices()
    need = n_chains * n_state
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    grid = np.array(devs[:need]).reshape(n_chains, n_state)
    return Mesh(grid, (chain_axis, state_axis))


def shard_over_chains(mesh: Mesh, tree: Any, axis_name: str = CHAINS_AXIS) -> Any:
    """Place every array in ``tree`` with its leading (chain) axis sharded
    over the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))

    def put(x):
        return jax.device_put(x, sharding)

    return jax.tree_util.tree_map(put, tree)


def shard_batch_state(
    mesh: Mesh,
    y0: Any,
    chain_axis: str = CHAINS_AXIS,
    state_axis: str = STATE_AXIS,
) -> Any:
    """Place a (B, n) initial-state batch with chains on the first mesh axis
    and the state vector on the second (for ``make_mesh_2d`` meshes)."""
    return jax.device_put(y0, NamedSharding(mesh, P(chain_axis, state_axis)))
