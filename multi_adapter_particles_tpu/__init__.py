"""multi_adapter_particles_tpu — a JAX particle simulation + rendering framework
for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capability set of
GameTechDev/Multi-Adapter-Particles (a D3D12 multi-adapter n-body demo):

- softened-gravity particle simulation (central-well O(N) and all-pairs O(N^2))
  as jitted XLA programs and a blocked Pallas (Triton) kernel,
- a headless point-sprite splat renderer (the ParticleDraw.hlsl analog),
- double-buffered (ping-pong) functional state with buffer donation,
- one-device fused mode (async-compute analog) and multi-device split mode
  (multi-adapter analog: sharded sim + ring position exchange between
  devices + overlapped transfer to a render device),
- live elastic re-sharding (the live adapter re-assignment analog),
- per-stage timing, metrics, CLI and runtime-mutable config knobs
  (numSim/numCopy/numDraw decoupling preserved).

Nothing here is a translation of the reference's C++/HLSL; the reference
(cited by file:line throughout) defines behavior, not implementation.
"""

from multi_adapter_particles_tpu import constants
from multi_adapter_particles_tpu.config import (
    AppConfig,
    RenderConfig,
    SimConfig,
)
from multi_adapter_particles_tpu.models.state import ParticleState

__version__ = "0.1.0"

__all__ = [
    "AppConfig",
    "RenderConfig",
    "SimConfig",
    "ParticleState",
    "constants",
    "__version__",
]
