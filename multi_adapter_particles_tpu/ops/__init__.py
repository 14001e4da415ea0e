"""Device-side hot loops and the choice of their implementation.

These are the HLSL analogs (`nBodyGravityCS.hlsl`, `ParticleDraw.hlsl`):

- `allpairs.py`   — the tiled O(N^2) bodyBodyInteraction force as a Pallas
  kernel for the Triton route: source tiles streamed past register-held
  targets (the groupshared-memory analog).
- `composite.py`  — the segmented-blend (splat composite) kernel, same
  route; the tile-binned rasterizer that feeds it lives in
  `render/renderer.py`.
- `pm.py`, `p3m.py`, `treeforce.py` — the mesh and near-field force
  models, plain XLA.

Every kernel has an XLA formulation, which is the reference in tests and
the implementation on backends without the kernel; `dispatch.py` makes
that choice per device.
"""

from multi_adapter_particles_tpu.ops.dispatch import (
    all_pairs_impl,
    composite_impl,
    has_kernels,
)

__all__ = ["all_pairs_impl", "composite_impl", "has_kernels"]
