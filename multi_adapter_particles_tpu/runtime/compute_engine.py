"""Compute engine: owns the sim device, the jitted step, and particle state.

The reference's `class Compute` (`Particles/Compute.{h,cpp}`) owns a compute
queue, ping-pong UAV buffers, the compiled CSMain PSO, and a shared fence.
Here:

- the "queue" is async XLA dispatch onto `self.device`,
- the ping-pong pair is functional state + buffer donation
  (`Compute.cpp:52-62,1030-1035` descriptor-sliding done by XLA aliasing),
- the "PSO" is the jitted step callable, chosen per force model and, for
  all-pairs, per device (`ops/dispatch.all_pairs_impl`),
- the shared fence is a data dependency: `positions` handed to the render
  engine *is* the fence value (`Compute::GetFenceValue`, `Compute.cpp:446`),
- `WaitForGpu` is a hard sync on the state,
- constructing with `prev=` migrates state from a dying engine on another
  device — the `Compute::CopyState` live-reassignment path
  (`Compute.cpp:303-410`), minus the 3-hop velocity smuggle: `device_put`
  moves the whole pytree in one shot.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models import init as pinit
from multi_adapter_particles_tpu.models import integrator
from multi_adapter_particles_tpu.models.state import ParticleState
from multi_adapter_particles_tpu.ops import dispatch
from multi_adapter_particles_tpu.utils.metrics import MetricsRegistry
from multi_adapter_particles_tpu.utils.timers import sync


class ComputeEngine:
    """Simulation role bound to one jax device.

    `simulate()` is fire-and-forget (async dispatch), mirroring
    `Compute::Simulate`'s ExecuteCommandLists + Signal (`Compute.cpp:1009-1055`).
    """

    def __init__(
        self,
        sim_config: SimConfig,
        device: jax.Device,
        metrics: Optional[MetricsRegistry] = None,
        prev: Optional["ComputeEngine"] = None,
        seed: int = 0,
        all_pairs_impl: Optional[str] = None,
        donate: bool = True,
        extension=None,
    ):
        self.config = sim_config
        self.device = device
        self.metrics = metrics or MetricsRegistry()
        if all_pairs_impl is None:
            all_pairs_impl = dispatch.all_pairs_impl(device)
        self.all_pairs_impl = all_pairs_impl
        self._step = integrator.make_step(
            sim_config,
            accel_fn=integrator.make_accel_fn_for(sim_config, all_pairs_impl),
            donate=donate,
        )
        # Perf-extension layer (ExtensionHelper analog): when active, the
        # full-count step is recompiled with perf compiler options.
        self.extension = extension
        self._step_fast = None
        self.step_count = 0  # the shared fence value analog

        if prev is not None:
            # CopyState: drain the old engine, then migrate the full pytree.
            prev.wait_for_gpu()
            self.state = jax.device_put(prev.state, device)
            self.step_count = prev.step_count
        else:
            with jax.default_device(device):
                self.state = pinit.initialize_particles_device(
                    sim_config.num_particles, seed=seed
                )

    # -- frame ops ---------------------------------------------------------------
    def simulate(self, num_sim: Optional[int] = None) -> ParticleState:
        """One async step. Returns the new state (also kept on self)."""
        if num_sim is None and self.extension is not None:
            if self._step_fast is None and self.extension.active:
                self._step_fast = self.extension.compile(self._step, self.state)
            if self._step_fast is not None and self.extension.enabled:
                self.state = self._step_fast(self.state)
                self.step_count += 1
                self._count_interactions(self.config.num_particles)
                return self.state
        self.state = self._step(self.state, num_sim)
        self.step_count += 1
        self._count_interactions(
            num_sim if num_sim is not None else self.config.num_particles
        )
        return self.state

    def _count_interactions(self, n_sim: int) -> None:
        if self.config.force_model == "all_pairs":
            self.metrics.count(
                "interactions", float(n_sim) * self.state.padded_count
            )
        else:
            self.metrics.count("interactions", float(n_sim))

    @property
    def positions(self) -> jax.Array:
        """The shared-buffer handle the render side consumes
        (`Compute::GetSharedHandles` analog)."""
        return self.state.position

    def get_fence_value(self) -> int:
        return self.step_count

    def wait_for_gpu(self) -> None:
        """Drain: hard host sync on the current state (`Compute::WaitForGpu`)."""
        sync(self.state)

    # -- snapshots (checkpoint/resume generalization, SURVEY §5) ----------------
    def snapshot(self):
        """Host-side copy of the state pytree (positions + velocities)."""
        self.wait_for_gpu()
        return jax.device_get(self.state)

    def restore(self, host_state) -> None:
        self.state = jax.device_put(
            ParticleState(
                jnp.asarray(host_state.position), jnp.asarray(host_state.velocity)
            ),
            self.device,
        )
