"""Runtime layer: device roles, engines, orchestrator — the app core.

The reference's L5/L4 layers (`Particles/Particles.cpp`, `Render.cpp`,
`Compute.cpp`) re-designed for JAX: queues and fences become async XLA
dispatch plus data dependencies; the cross-adapter shared heap becomes a
device-to-device `jax.device_put`; live adapter re-assignment becomes state
migration between jax devices (or meshes).
"""

from multi_adapter_particles_tpu.runtime.devices import (
    AdapterInfo,
    enumerate_adapters,
    assign_adapters,
)
from multi_adapter_particles_tpu.runtime.compute_engine import ComputeEngine
from multi_adapter_particles_tpu.runtime.render_engine import RenderEngine
from multi_adapter_particles_tpu.runtime.orchestrator import ParticlesApp

__all__ = [
    "AdapterInfo",
    "enumerate_adapters",
    "assign_adapters",
    "ComputeEngine",
    "RenderEngine",
    "ParticlesApp",
]
