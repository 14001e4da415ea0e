"""Fused single-program frame: sim step + splat render in ONE jit.

The reference's single-adapter async-compute mode shares one device between
the compute and direct queues with zero copies, interleaved by fences
(`Compute::SetAsync`, `Compute.cpp:956-987`; `Render.cpp:844-852`). The
XLA version goes further: the whole frame — render state N
(stale-by-one, the reference's contract) then integrate to N+1 — is one
compiled XLA program with the state donated, so there are no per-stage
dispatch gaps, no host round-trips, and XLA schedules/fuses across the
stage boundary.

`FusedEngine` satisfies both engine interfaces (compute: positions/fence/
simulate bookkeeping; render: camera/last_frame/present), so the
orchestrator can slot it into both roles. Per-stage timers work in fused
mode too (the reference shows "simulate ms"/"render ms" in BOTH modes —
`Compute.cpp:445-446`, `Render.cpp:151-152`, displayed
`Particles.cpp:399-409`): with `stage_markers=True` the frame program
threads the state through two `lax.optimization_barrier`s, one before the
render stage and one that also consumes a scalar anchor over every render
output. Each carries a tiny sentinel-shaped broadcast whose kernel is
recognizable in the profiler trace. The barriers are identities (the
trajectory stays bitwise-equal) but order the stages, so
`runtime/gputimer.parse_stage_ms` can split the ONE module's device time
into render (kernels between the markers) and simulate (kernels after
the boundary) without breaking the single-program contract.

The frame program keeps TWO state buffers and ping-pongs them explicitly —
the descriptor-base-sliding analog (`Compute.cpp:52-62,1030-1035`): the
CURRENT state is passed un-donated (so the render stage and the integrator
both read it freely, no copy and no hazard), while the PREVIOUS frame's
state buffers are passed donated as scratch for the integrator's output.
The caller swaps the two handles every frame. Round 1 donated the single
current state instead, which forced XLA to copy it so the stale-by-one
render could still read it — a full-state copy per frame.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_tpu.models import init as pinit
from multi_adapter_particles_tpu.models import integrator
from multi_adapter_particles_tpu.models.state import ParticleState
from multi_adapter_particles_tpu.ops import dispatch
from multi_adapter_particles_tpu.render import renderer as rmod
from multi_adapter_particles_tpu.render.camera import Camera
from multi_adapter_particles_tpu.utils.metrics import MetricsRegistry
from multi_adapter_particles_tpu.utils.timers import sync


class FusedEngine:
    def __init__(
        self,
        sim_config: SimConfig,
        render_config: RenderConfig,
        device: jax.Device,
        metrics: Optional[MetricsRegistry] = None,
        seed: int = 0,
        all_pairs_impl: Optional[str] = None,
        donate: bool = True,
        prev=None,
        stage_markers: bool = False,
    ):
        self.config = sim_config
        self.render_config = render_config
        self.device = device
        self.metrics = metrics or MetricsRegistry()
        self.camera = Camera(position=render_config.camera_position)
        self.renderer = rmod.Renderer(render_config)  # param source + utils
        if all_pairs_impl is None:
            all_pairs_impl = dispatch.all_pairs_impl(device)
        self.all_pairs_impl = all_pairs_impl
        self.step_count = 0
        self.frame_count = 0
        self._frame = None
        # per-frame scalar upload cache (see Renderer._arg_key)
        self._arg_key = None
        self._arg_dev = None

        # unjitted: the fused frame program inlines the step
        step_core = integrator.make_step(
            sim_config,
            accel_fn=integrator.make_accel_fn_for(sim_config, all_pairs_impl),
            donate=False,
        )
        self._step_core = step_core
        self._donate = donate
        self.stage_markers = stage_markers
        self._fused = self._rebuild_fused()

        if prev is not None:
            prev.wait_for_gpu()
            self.state = jax.device_put(prev.state, device)
            self.step_count = prev.get_fence_value()
        else:
            with jax.default_device(device):
                self.state = pinit.initialize_particles_device(
                    sim_config.num_particles, seed=seed
                )
        self._scratch = self._fresh_scratch()

    def _rebuild_fused(self):
        """(Re)wrap the fused frame program in a fresh jit.

        The program closes over the renderer's dup window (and blend /
        chunk sizing) at trace time, and a jit cache key excludes
        closure values — so a dup auto-raise (`present`) must rebuild
        the wrapper for the next frame to retrace with the new window
        (split mode gets this for free from `_render`'s static args)."""
        rcfg = self.render_config
        step_core = self._step_core

        def fused(state, scratch, wvp, p00, p11, radius, intensity, num_draw,
                  num_sim):
            # `state` (frame N) is NOT donated: render and integrate both
            # read it with no copy. `scratch` is frame N-1's retired buffers,
            # donated so the integrator's output aliases them — the explicit
            # two-buffer ping-pong (`Compute.cpp:52-62,1030-1035`).
            del scratch  # storage donor only; contents are dead
            begin = None
            if self.stage_markers:
                # Stage START marker for the fused per-stage timer: a tiny
                # sentinel-shaped broadcast ([1, STAGE_BEGIN_COLS]) that
                # reads the state, threaded with it through an
                # optimization barrier, so every render kernel that reads
                # positions runs after it (see the boundary marker below)
                from multi_adapter_particles_tpu.runtime.gputimer import (
                    STAGE_BEGIN_COLS,
                )

                begin = jnp.broadcast_to(
                    state.position[0, 0] * 0.0 + radius, (1, STAGE_BEGIN_COLS)
                )
                state, begin = jax.lax.optimization_barrier((state, begin))
            # draw frame N (pre-step positions: the stale-by-one contract)...
            rend = self.renderer
            if state.padded_count > rend.chunk_threshold:
                # the same id-ordered associative fold as split mode;
                # the whole fold inlines into the one frame program
                # (static chunk count)
                _, cn = rmod._chunk_width(
                    state.padded_count, rend.chunk_size
                )
                q = rend.resolve_seg_q(cn)
                out = rmod._chunked_fold(
                    state.position, wvp, p00, p11, radius, intensity,
                    num_draw,
                    width=rcfg.width, height=rcfg.height, seg_q=q,
                    dup_y=rend.dup_y, dup_x=rend.dup_x,
                    near=rcfg.near, blend=rend.blend,
                    composite=rend.composite,
                    chunk_size=rend.chunk_size,
                    frame_uint8=False,  # fused frames stay float,
                    #                     matching the _render call below
                )
            else:
                q = rend.resolve_seg_q(state.padded_count)
                out = rmod._render(
                    state.position, wvp, p00, p11, radius, intensity,
                    num_draw,
                    width=rcfg.width, height=rcfg.height,
                    seg_q=q,
                    dup_y=rend.dup_y, dup_x=rend.dup_x,
                    near=rcfg.near, blend=rend.blend,
                    composite=rend.composite,
                )
            # ...while/then integrating to N+1, all inside one program
            marker = None
            if self.stage_markers:
                # Stage boundary for the fused per-stage timer: a tiny
                # sentinel-shaped broadcast ([1, STAGE_MARKER_COLS]) of an
                # anchor that consumes every render output, threaded with
                # the state through an optimization barrier. The barrier
                # is bitwise inert (state passes through untouched) but
                # (a) forces every sim op after every render op and
                # (b) its kernel is recognizable in the profiler's kernel
                # stream (`gputimer.parse_stage_ms` splits there; the
                # opt-barrier op itself need not emit a trace event).
                # (a) forfeits some cross-stage scheduling: the price of
                # the reference's both-modes timer parity.
                from multi_adapter_particles_tpu.runtime.gputimer import (
                    STAGE_MARKER_COLS,
                )

                anchor = (
                    out.frame.ravel()[0].astype(jnp.float32)
                    + out.truncated.astype(jnp.float32)
                    + out.span_y.astype(jnp.float32)
                    + out.span_x.astype(jnp.float32)
                )
                marker = jnp.broadcast_to(anchor, (1, STAGE_MARKER_COLS))
                state, marker = jax.lax.optimization_barrier(
                    (state, marker)
                )
            new_state = step_core(state, num_sim)
            # the markers ride as aux outputs so their producers can't be
            # dead-code-eliminated (None when markers are off)
            return new_state, out, (begin, marker)

        return jax.jit(
            fused,
            static_argnums=(8,),
            donate_argnums=(1,) if self._donate else (),
        )

    def _fresh_scratch(self) -> ParticleState:
        """Second ping-pong buffer set (contents dead; storage donor)."""
        with jax.default_device(self.device):
            return jax.tree_util.tree_map(jnp.zeros_like, self.state)

    # -- the frame -----------------------------------------------------------
    def frame(
        self,
        app: AppConfig,
        num_sim: Optional[int] = None,
        num_draw: Optional[int] = None,
    ):
        cfg = self.render_config
        proj = self.camera.projection_matrix(
            cfg.aspect, cfg.fov_y, cfg.near, cfg.far
        )
        wvp = self.camera.world_view_projection(
            cfg.aspect, fov_y=cfg.fov_y, near=cfg.near, far=cfg.far
        )
        n = self.state.padded_count
        rend = self.renderer
        # auto-raise bookkeeping (present() budgets dup growth against
        # the per-dispatch sort size, exactly like the split renderer)
        rend._last_n = n
        rend._last_sort_n = (
            rmod._chunk_width(n, rend.chunk_size)[1]
            if n > rend.chunk_threshold else n
        )
        nd = int(n if num_draw is None else num_draw)
        akey = (
            wvp.tobytes(), float(proj[0, 0]), float(proj[1, 1]),
            float(app.particle_size), float(app.particle_intensity), nd,
        )
        if akey != self._arg_key:
            self._arg_dev = (
                jnp.asarray(wvp),
                jnp.float32(abs(proj[0, 0])),
                jnp.float32(abs(proj[1, 1])),
                jnp.float32(app.particle_size),
                jnp.float32(app.particle_intensity),
                jnp.int32(nd),
            )
            self._arg_key = akey
        new_state, self._frame, _marker = self._fused(
            self.state,
            self._scratch,
            *self._arg_dev,
            num_sim,
        )
        # ping-pong: frame N's buffers become next frame's scratch donor
        self._scratch, self.state = self.state, new_state
        self.step_count += 1
        self.frame_count += 1
        return self._frame

    # -- compute-engine interface ------------------------------------------------
    @property
    def positions(self) -> jax.Array:
        return self.state.position

    def get_fence_value(self) -> int:
        return self.step_count

    def wait_for_gpu(self) -> None:
        sync(self.state)
        if self._frame is not None and not self._frame.frame.is_deleted():
            sync(self._frame.frame)

    def snapshot(self):
        self.wait_for_gpu()
        return jax.device_get(self.state)

    def restore(self, host_state) -> None:
        self.state = jax.device_put(
            ParticleState(
                jnp.asarray(host_state.position),
                jnp.asarray(host_state.velocity),
            ),
            self.device,
        )
        self._scratch = self._fresh_scratch()

    # -- render-engine interface ----------------------------------------------
    @property
    def last_frame(self):
        return None if self._frame is None else self._frame.frame

    def present(self):
        """Fence on the last frame — and the same deferred dup
        auto-raise contract as `RenderEngine.present`: ONE packed host
        read carries fence + truncated + spans, a truncating frame grows
        the window for FUTURE frames, and (fused-specific) the frame
        program is rebuilt so the next frame retraces with the new
        window (the old jit baked dup into its closure; sprites past the
        window stayed truncated for the rest of the run)."""
        f = self._frame
        if f is None:
            return None
        rend = self.renderer
        if rend.auto_raise_dup:
            from multi_adapter_particles_tpu.runtime.render_engine import (
                _present_probe,
            )

            vals = jax.device_get(
                _present_probe(f.frame, f.truncated, f.span_y, f.span_x)
            )
            rend.last_truncated = int(vals[1])
            if rend.raise_dup_values(
                int(vals[1]), int(vals[2]), int(vals[3])
            ):
                self._fused = self._rebuild_fused()
        else:
            sync(f.frame)
        return self._frame
