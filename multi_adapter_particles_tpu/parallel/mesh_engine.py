"""Mesh-backed compute engine: the multi-chip "compute adapter".

Presents the same engine interface as `runtime.ComputeEngine` (simulate /
positions / wait_for_gpu / fence / snapshot-restore), so the orchestrator
can treat a whole mesh as one adapter. Construction with `prev=` migrates
state from any other engine — single-device or mesh — which is both the
live adapter re-assignment analog (`Compute::CopyState`, `Compute.cpp:303-410`)
and the elastic re-sharding path (BASELINE.json "runtime shard rebalancing").
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models import init as pinit
from multi_adapter_particles_tpu.models.state import ParticleState
from multi_adapter_particles_tpu.parallel import sharded as shmod
from multi_adapter_particles_tpu.parallel.mesh import mesh_devices
from multi_adapter_particles_tpu.utils.metrics import MetricsRegistry
from multi_adapter_particles_tpu.utils.timers import sync


class MeshComputeEngine:
    def __init__(
        self,
        sim_config: SimConfig,
        mesh: Mesh,
        metrics: Optional[MetricsRegistry] = None,
        prev=None,
        seed: int = 0,
        all_pairs_impl: Optional[str] = None,
        donate: bool = True,
        bit_stable: Optional[bool] = None,
    ):
        self.config = sim_config
        self.mesh = mesh
        self.metrics = metrics or MetricsRegistry()
        self._step = shmod.make_sharded_step(
            sim_config, mesh, all_pairs_impl=all_pairs_impl, donate=donate,
            bit_stable=bit_stable,
        )
        self.step_count = 0

        if prev is not None:
            # NOTE: like the reference (the old Compute is destroyed right
            # after CopyState, Particles.cpp:512-522), `prev` must not be
            # stepped or read after migration: if the new sharding is
            # layout-identical, device_put aliases the buffers zero-copy
            # and this engine's donating step will retire them.
            prev.wait_for_gpu()
            self.state = shmod.shard_state(prev.state, mesh)
            self.step_count = prev.get_fence_value()
        else:
            # Initialize on the default device then shard (init is a
            # one-time cost; a fully-sharded init is a future optimization).
            init = pinit.initialize_particles_device(
                sim_config.num_particles, seed=seed
            )
            self.state = shmod.shard_state(init, mesh)

        if self.state.padded_count % mesh.devices.size:
            raise ValueError(
                f"padded count {self.state.padded_count} not divisible by "
                f"mesh size {mesh.devices.size}"
            )

    # -- engine interface ------------------------------------------------------
    @property
    def device(self):
        return mesh_devices(self.mesh)[0]

    def simulate(self, num_sim: Optional[int] = None) -> ParticleState:
        if num_sim is not None and num_sim >= self.config.num_particles:
            num_sim = None
        self.state = self._step(self.state, num_sim)
        self.step_count += 1
        n = self.config.num_particles
        self.metrics.count(
            "interactions",
            float(n) * (self.state.padded_count
                        if self.config.force_model == "all_pairs" else 1.0),
        )
        return self.state

    @property
    def positions(self) -> jax.Array:
        return self.state.position

    def get_fence_value(self) -> int:
        return self.step_count

    def wait_for_gpu(self) -> None:
        sync(self.state)

    def snapshot(self):
        self.wait_for_gpu()
        return jax.device_get(self.state)

    def restore(self, host_state) -> None:
        self.state = shmod.shard_state(
            ParticleState(
                jnp.asarray(host_state.position),
                jnp.asarray(host_state.velocity),
            ),
            self.mesh,
        )
