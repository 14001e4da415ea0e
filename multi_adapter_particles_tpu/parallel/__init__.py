"""Multi-device parallelism: mesh sharding, ring force exchange, resharding.

The reference's multi-adapter mode (compute on one GPU, render on another,
copy queue between — `Compute.cpp:163-251`, `Render.cpp:789-831`) maps to:

- particle state sharded over a `jax.sharding.Mesh` along the particle axis,
- the all-pairs force as a **ring**: each stage computes forces from the
  resident position block while `ppermute` rotates the next block to the
  neighbour device —
  structurally identical to ring attention, applied to particle tiles
  (SURVEY §5 "long-context" analog),
- the render feed as a gather of the sharded positions onto the render
  device (the copy-queue transfer analog),
- elastic re-sharding between meshes = the live adapter re-assignment.
"""

from multi_adapter_particles_tpu.parallel.mesh import make_mesh, mesh_devices
from multi_adapter_particles_tpu.parallel.sharded import (
    make_sharded_step,
    shard_state,
)
from multi_adapter_particles_tpu.parallel.mesh_engine import MeshComputeEngine
from multi_adapter_particles_tpu.parallel.resharding import reshard_state

__all__ = [
    "make_mesh",
    "mesh_devices",
    "make_sharded_step",
    "shard_state",
    "MeshComputeEngine",
    "reshard_state",
]
