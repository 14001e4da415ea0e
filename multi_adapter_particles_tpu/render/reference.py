"""Exact sequential NumPy rasterizer — the golden-image oracle.

Implements the reference draw pipeline semantics precisely
(`ParticleDraw.hlsl`, `Render.cpp:494-552,876-891`):

- VS color rule (`ParticleDraw.hlsl:104-109`):
    mag   = pos.w / 9
    color = lerp((1, .1, .1), (1, 1, .2), mag)      # UNCLAMPED lerp
    blue  = (id & 0xfff) / 0xfff
    red   = 1 - blue
- GS: each particle expands to a camera-facing quad of radius
  `particle_size` in eye space (`ParticleDraw.hlsl:123-131`). Because the
  corners are offset in eye space by (+/-rad, +/-rad, 0) at the particle's
  depth, the quad projects to a screen-axis-aligned rectangle; uv
  interpolates affinely across it (all four corners share w = -z_eye).
- PS (`ParticleDraw.hlsl:140-145`): alpha = clamp(0.5 - |uv - 0.5|, 0, 0.5)
  * intensity; rgb passes through.
- Blend SRC_ALPHA / INV_SRC_ALPHA, no depth test, black clear, particles
  composited in draw order (= particle id order, one DrawInstanced call,
  `Render.cpp:891`).
- D3D viewport transform: pixel centers at integer+0.5, y down.

Deliberate deviation from D3D UNORM8 blending: instead of clamping (and
quantizing) the running framebuffer after EVERY blend, the source term is
clamped per sprite (src = clip(rgb * alpha, 0, 1)) and the final image is
clipped once. This makes over-composition exactly associative — (color,
transmittance) forms a monoid — which the renderer exploits to
composite deep tiles in parallel segments. The two rules differ only
when the unclamped running value would overshoot 1 (hot saturated cores,
where both converge to white); neither reproduces UNORM8 quantization.

O(N * sprite_area) per frame in Python/NumPy — use small N. The device
renderer (`renderer.py`) is validated against this bit-for-intent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from multi_adapter_particles_tpu import constants as C
from multi_adapter_particles_tpu.config import RenderConfig
from multi_adapter_particles_tpu.render.camera import Camera

F32 = np.float32


def particle_colors(accel_mag: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """VSParticleDraw color rule -> [N, 3] float32 (r, g, b)."""
    mag = accel_mag.astype(F32) / F32(C.ACCEL_COLOR_SCALE)
    cold = np.asarray(C.SPRITE_COLOR_COLD[:3], dtype=F32)
    hot = np.asarray(C.SPRITE_COLOR_HOT[:3], dtype=F32)
    rgb = cold[None, :] + mag[:, None] * (hot - cold)[None, :]  # unclamped
    blue = ((ids & C.SPRITE_ID_MASK).astype(F32)) / F32(C.SPRITE_ID_MASK)
    rgb[:, 2] = blue
    rgb[:, 0] = 1.0 - blue
    return rgb


def project_particles(
    positions: np.ndarray,  # [N, >=3] world xyz
    camera: Camera,
    config: RenderConfig,
):
    """Project to screen space. Returns (cx, cy, half_x, half_y, w_clip):
    centers in pixels (D3D convention: origin top-left, y down), half
    extents in pixels, positive w = distance along view dir."""
    n = positions.shape[0]
    view = camera.view_matrix().astype(np.float64)
    proj = camera.projection_matrix(config.aspect).astype(np.float64)
    p = np.concatenate(
        [positions[:, :3].astype(np.float64), np.ones((n, 1))], axis=1
    )
    eye = p @ view  # row-vector
    clip = eye @ proj
    w = clip[:, 3]  # = -z_eye
    with np.errstate(divide="ignore", invalid="ignore"):
        ndc = clip[:, :3] / w[:, None]
    cx = (ndc[:, 0] + 1.0) * 0.5 * config.width
    cy = (1.0 - ndc[:, 1]) * 0.5 * config.height
    # eye-space offset +/-rad maps to ndc +/- rad*P00/w -> pixels
    half_x = np.abs(proj[0, 0]) / w * 0.5 * config.width
    half_y = np.abs(proj[1, 1]) / w * 0.5 * config.height
    return cx, cy, half_x, half_y, w


def render_reference(
    positions: np.ndarray,  # [N, 4] world (x, y, z, |accel|)
    config: Optional[RenderConfig] = None,
    camera: Optional[Camera] = None,
    particle_size: float = C.INITIAL_PARTICLE_SIZE,
    particle_intensity: float = C.INITIAL_PARTICLE_INTENSITY,
    num_draw: Optional[int] = None,
) -> np.ndarray:
    """Rasterize to a float32 [H, W, 3] framebuffer in [0, 1]."""
    config = config or RenderConfig()
    camera = camera or Camera()
    n = positions.shape[0] if num_draw is None else min(num_draw, positions.shape[0])
    positions = positions[:n]

    frame = np.zeros((config.height, config.width, 3), dtype=F32)
    if n == 0:
        return frame

    rgb = particle_colors(positions[:, 3], np.arange(n))
    cx, cy, hx, hy, w = project_particles(positions, camera, config)
    rad = float(particle_size)
    hx = hx * rad
    hy = hy * rad

    for i in range(n):
        if not (w[i] > config.near):  # behind camera / at eye: clipped
            continue
        x0 = cx[i] - hx[i]
        x1 = cx[i] + hx[i]
        y0 = cy[i] - hy[i]
        y1 = cy[i] + hy[i]
        # pixels whose centers fall inside [x0, x1) x [y0, y1)
        px0 = max(int(np.ceil(x0 - 0.5)), 0)
        px1 = min(int(np.ceil(x1 - 0.5)), config.width)
        py0 = max(int(np.ceil(y0 - 0.5)), 0)
        py1 = min(int(np.ceil(y1 - 0.5)), config.height)
        if px0 >= px1 or py0 >= py1:
            continue
        xs = np.arange(px0, px1, dtype=F32) + F32(0.5)
        ys = np.arange(py0, py1, dtype=F32) + F32(0.5)
        u = (xs - F32(x0)) / F32(x1 - x0)
        v = (ys - F32(y0)) / F32(y1 - y0)
        du = u - F32(0.5)
        dv = v - F32(0.5)
        dist = np.sqrt(du[None, :] ** 2 + dv[:, None] ** 2)
        alpha = np.clip(F32(0.5) - dist, 0.0, 0.5) * F32(particle_intensity)
        tile = frame[py0:py1, px0:px1, :]
        src = np.clip(rgb[i][None, None, :] * alpha[:, :, None], 0.0, 1.0)
        frame[py0:py1, px0:px1, :] = src + tile * (1.0 - alpha[:, :, None])
    return np.clip(frame, 0.0, 1.0)
