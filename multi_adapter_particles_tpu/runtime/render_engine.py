"""Render engine: owns the render device, camera, splatter, and local buffers.

The reference's `class Render` (`Particles/Render.{h,cpp}`) owns the direct +
copy queues, the swap chain, and two *local* particle buffers that the copy
queue fills from the cross-adapter shared heap each frame
(`Render.cpp:727-759,789-831`). Here:

- the copy queue is `jax.device_put` of the positions array onto the render
  device — async, overlapping with whatever else is in flight (split mode);
  in async single-device mode it is the zero-copy identity, exactly like the
  reference's same-adapter mode skipping `CopySimulationResults`
  (`Render.cpp:844-852`);
- the `num_copy` knob transfers only the first `num_copy` particle columns
  and leaves the rest of the local buffer *stale* — the reference copies
  exactly `numCopied * 16` bytes (`Render.cpp:814`) with identical
  stale-tail semantics;
- the swap chain is the host-side frame handle: `draw()` returns the frame
  array (async); `present()` blocks on it — the single per-frame host wait
  (`Particles.cpp:452-456`).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from multi_adapter_particles_tpu.config import AppConfig, RenderConfig
from multi_adapter_particles_tpu.render.camera import Camera
from multi_adapter_particles_tpu.render.renderer import Renderer, FrameOutput
from multi_adapter_particles_tpu.utils.metrics import MetricsRegistry
from multi_adapter_particles_tpu.utils.timers import sync
from multi_adapter_particles_tpu.models.state import PAD_POSITION


@functools.partial(jax.jit, donate_argnums=(0,))
def _splice(local: jax.Array, incoming: jax.Array) -> jax.Array:
    """Overwrite the first columns of the local buffer with `incoming`
    (CopyBufferRegion of numCopied*16 bytes, `Render.cpp:814`)."""
    return jax.lax.dynamic_update_slice(local, incoming, (0, 0))


@jax.jit
def _present_probe(frame, truncated, span_y, span_x):
    """[4] f32 carrying (frame anchor, truncated, span_y, span_x).

    present() needs BOTH a completion fence on the frame and the
    auto-raise scalars; read separately each costs a full host round
    trip. Packing them into one tiny dependent array makes present a
    SINGLE device_get: the first element depends on the frame data, so
    materializing it IS the fence."""
    anchor = frame.ravel()[0].astype(jnp.float32) * 0.0
    return jnp.stack([
        anchor,
        truncated.astype(jnp.float32),
        span_y.astype(jnp.float32),
        span_x.astype(jnp.float32),
    ])


class RenderEngine:
    def __init__(
        self,
        render_config: RenderConfig,
        device: jax.Device,
        metrics: Optional[MetricsRegistry] = None,
        camera: Optional[Camera] = None,
        renderer: Optional[Renderer] = None,
    ):
        self.config = render_config
        self.device = device
        self.metrics = metrics or MetricsRegistry()
        self.camera = camera or Camera(position=render_config.camera_position)
        self.renderer = renderer or Renderer(render_config)
        # Local particle buffer (the dGPU-resident copy target,
        # Render.cpp:727-759). Allocated lazily at first copy. `_local_owned`
        # distinguishes a buffer this engine allocated (safe to donate into
        # _splice) from a zero-copy alias of the compute state (which the
        # sim may donate away at any time).
        self._local: Optional[jax.Array] = None
        self._local_owned = False
        self._frame: Optional[FrameOutput] = None
        self.frame_count = 0
        # When set (orchestrator, -shardrender), frames render sharded
        # over this mesh: no position copy; per-device (C, T) image pairs
        # are the only cross-device traffic (renderer.render_mesh).
        self.mesh = None

    # -- copy stage (the copy-queue analog) -------------------------------------
    def copy_simulation_results(
        self, shared_positions: jax.Array, num_copy: Optional[int] = None
    ) -> jax.Array:
        """Pull sim results into the render device's local buffer.

        Same-device: identity (async mode, zero copies). Cross-device: an
        async device-to-device transfer of exactly the first `num_copy` columns
        (padded to the lane multiple); the tail stays stale.
        """
        n = shared_positions.shape[1]
        nc = n if num_copy is None else min(int(num_copy), n)
        nc = -(-nc // 128) * 128  # lane-align the slice boundary
        nc = min(nc, n)

        # zero-copy only when the source lives entirely on the render
        # device (a mesh-sharded source must go through the gather below)
        if shared_positions.devices() == {self.device} and nc >= n:
            self._local = shared_positions  # zero-copy async mode: an ALIAS
            self._local_owned = False
            return self._local

        incoming = jax.device_put(shared_positions[:, :nc], self.device)
        self.metrics.count("transfer_bytes", float(nc) * 16.0)
        if nc >= n:
            self._local = incoming
            self._local_owned = True
        else:
            if (
                not self._local_owned
                or self._local is None
                or self._local.is_deleted()
                or self._local.shape != shared_positions.shape
            ):
                # never splice into an alias of the compute state — the sim
                # step may have donated (or still own) that buffer
                base = jnp.full(
                    shared_positions.shape, PAD_POSITION, dtype=jnp.float32
                ).at[3, :].set(0.0)
                self._local = jax.device_put(base, self.device)
            self._local = _splice(self._local, incoming)
            self._local_owned = True
        return self._local

    # -- draw stage ----------------------------------------------------------------
    def draw(
        self,
        shared_positions: jax.Array,
        app: AppConfig,
        num_copy: Optional[int] = None,
        num_draw: Optional[int] = None,
    ) -> FrameOutput:
        """Record + dispatch one frame (async). The reference's
        `Render::Draw` (`Render.cpp:839-935`) minus the OS present."""
        n = shared_positions.shape[1]
        if self.mesh is not None and (num_copy is None or num_copy >= n):
            # Sharded render: shards rasterize in place; the copy stage is
            # replaced by the (C, T) image-pair gather. A num_copy below N
            # (the stale-tail decoupling knob) needs the local-buffer
            # semantics — it falls through to the gather path below.
            self._frame = self.renderer.render_mesh(
                shared_positions,
                self.camera,
                particle_size=app.particle_size,
                particle_intensity=app.particle_intensity,
                mesh=self.mesh,
                num_draw=num_draw,
            )
            d = int(np.prod(list(self.mesh.shape.values())))
            h, w = self.config.height, self.config.width
            self.metrics.count("transfer_bytes", float(d * h * w * 16))
            self.frame_count += 1
            return self._frame
        local = self.copy_simulation_results(shared_positions, num_copy)
        self._frame = self.renderer.render_arrays(
            local,
            self.camera,
            particle_size=app.particle_size,
            particle_intensity=app.particle_intensity,
            num_draw=num_draw,
        )
        self.frame_count += 1
        return self._frame

    # -- present ---------------------------------------------------------------------
    def present(self) -> Optional[FrameOutput]:
        """Block until the last frame is really finished — the
        latency-waitable-swapchain host wait (`Particles.cpp:452-456`).

        One packed host read carries the fence AND the auto-raise
        scalars (`_present_probe`) instead of two round trips."""
        f = self._frame
        if f is not None:
            if self.renderer.auto_raise_dup:
                vals = np.asarray(
                    jax.device_get(
                        _present_probe(
                            f.frame, f.truncated, f.span_y, f.span_x
                        )
                    )
                )
                # Deferred auto-raise: a truncating frame (sprite bigger
                # than the dup window) grows the window for FUTURE frames.
                # The already-presented frame is not re-rendered — the next
                # one is lossless (one recompile per growth).
                self.renderer.raise_dup_values(
                    int(vals[1]), int(vals[2]), int(vals[3])
                )
            else:
                sync(f.frame)
        return self._frame

    @property
    def last_frame(self) -> Optional[jax.Array]:
        return None if self._frame is None else self._frame.frame

    def wait_for_gpu(self) -> None:
        if self._frame is not None:
            sync(self._frame.frame)
        if self._local is not None and not self._local.is_deleted():
            # In zero-copy async mode _local aliases the compute state, which
            # may since have been donated into the next step — skip it then.
            sync(self._local)
