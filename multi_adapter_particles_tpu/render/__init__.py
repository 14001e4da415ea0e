"""Headless point-sprite renderer: the ParticleDraw.hlsl + swap-chain analog.

The reference renders particles as camera-facing quads with a radial-gradient
alpha sprite, SRC_ALPHA/INV_SRC_ALPHA blending, no depth, over a black clear
(`ParticleDraw.hlsl`, `Render.cpp:494-552,876-877`). Here that becomes a
headless framebuffer computed on device:

- `camera.py`    — SimpleCamera math (RH look-to view + perspective).
- `reference.py` — exact sequential NumPy rasterizer (the golden oracle).
- `renderer.py`  — tile-binned splatter (exact ordered compositing via
  stable sort by tile; order-independent additive mode for speed).
"""

from multi_adapter_particles_tpu.render.camera import Camera
from multi_adapter_particles_tpu.render.renderer import Renderer

__all__ = ["Camera", "Renderer"]
