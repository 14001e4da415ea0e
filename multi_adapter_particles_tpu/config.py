"""Configuration dataclasses — the three-tier config system.

The reference has compile-time defines (`defines.h`), a CLI (`ArgParser`,
`Particles.cpp:248-270`) and runtime GUI toggles with prev-value change
detection (`Particles.cpp:162-166,458-463`). Here the same split is:

- `SimConfig` / `RenderConfig`: static-under-jit parameters. Changing one
  forces a retrace, the analog of the reference's pipeline rebuild.
- `AppConfig`: runtime-mutable knobs (counts, size, intensity, mode flags)
  that flow through without retracing (or with cached bucketed retraces for
  the decoupled counts).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from multi_adapter_particles_tpu import constants as C


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Physics + sizing parameters for the simulation step.

    Defaults reproduce the reference exactly (`Compute.cpp:543-546`,
    `nBodyGravityCS.hlsl:37-38`).
    """

    num_particles: int = C.DEFAULT_NUM_PARTICLES
    dt: float = C.TIMESTEP
    damping: float = C.DAMPING
    mass: float = C.PARTICLE_MASS
    softening_squared: float = C.SOFTENING_SQUARED
    # 'central_well' = the shipped CSMain (nBodyGravityCS.hlsl:85-109).
    # 'all_pairs'    = the tiled O(N^2) bodyBodyInteraction model
    #                  (nBodyGravityCS.hlsl:44-57, unused upstream but kept).
    # 'pm_grid'      = FFT particle-mesh self-gravity (ops/pm.py): the same
    #                  pair law as all_pairs, O(N + G^3 log G) — exceeds the
    #                  reference (interactive self-gravity at 4M particles).
    # 'p3m'          = PM far field + exact pairwise near field (ops/p3m.py):
    #                  converges to the all_pairs force at EVERY separation.
    force_model: str = "central_well"
    # Multiplier applied per interaction in the all-pairs model — the
    # `particles` argument of bodyBodyInteraction (nBodyGravityCS.hlsl:54).
    # None = auto: 1.0 for central_well (the reference's baked constants,
    # `Compute.cpp:543-546`, are per-well, not per-pair) and 1/N for the
    # self-gravity models (all_pairs/pm_grid/p3m), which keeps the TOTAL
    # attracting mass at the central-well value instead of scaling it by
    # the particle count — forgetting the 1/N changed the physics by ~1e6x.
    interaction_scale: Optional[float] = None
    # pm_grid/p3m parameters: mesh resolution per axis and box extent (world
    # units); particles outside the box feel/exert no PM force.
    pm_grid_size: int = 64
    pm_box: float = 2048.0
    # p3m parameters: short-range cutoff in PM cells, and the static
    # per-near-cell particle capacity (overflowing particles keep the
    # smooth mesh force only; the overflow count is a runtime metric).
    p3m_cutoff_cells: float = 6.75
    p3m_capacity: int = 64
    # Near-field engine: "slots" = static-K 27-cell sweep; "tree" = the
    # Morton-block dual-tree sweep (ops/treeforce.py), exact on any
    # density contrast; "auto" = slots unless the CLI's startup overflow
    # probe finds the scene overflowing (then tree).
    p3m_near_mode: str = "auto"
    # Tree mode's static block-pair budget (None = density-free default;
    # the CLI sizes it from the scene via treeforce.host_pair_budget —
    # dropped pairs are counted, never silent).
    p3m_pair_budget: Optional[int] = None
    # Mesh runs: solve the PM field with the slab-decomposed distributed
    # FFT (parallel/dist_fft.py) instead of redundant per-device solves.
    # Worth it for G >= 256 (the doubled spectrum alone is 540 MB); needs
    # the inner mesh axis to divide the grid.
    pm_distributed_fft: bool = False

    def __post_init__(self):
        if self.num_particles <= 0:
            raise ValueError("num_particles must be positive")
        if self.force_model not in (
            "central_well", "all_pairs", "pm_grid", "p3m"
        ):
            raise ValueError(f"unknown force_model {self.force_model!r}")
        if self.interaction_scale is None:
            object.__setattr__(
                self,
                "interaction_scale",
                1.0
                if self.force_model == "central_well"
                else 1.0 / self.num_particles,
            )
        if self.p3m_near_mode not in ("auto", "slots", "tree"):
            raise ValueError(
                f"unknown p3m_near_mode {self.p3m_near_mode!r}"
            )
        if self.force_model == "p3m":
            from multi_adapter_particles_tpu.ops.p3m import (
                validate_cutoff_cells,
            )

            validate_cutoff_cells(self.p3m_cutoff_cells)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Camera + splat parameters (`Render.cpp:139,776`, `defines.h:40-41`)."""

    width: int = C.DEFAULT_WINDOW_WIDTH
    height: int = C.DEFAULT_WINDOW_HEIGHT
    fov_y: float = C.CAMERA_FOV_Y
    near: float = C.CAMERA_NEAR
    far: float = C.CAMERA_FAR
    camera_position: Tuple[float, float, float] = C.CAMERA_POSITION
    # Quantize the frame to RGB8 on device — the reference swap chain's
    # R8G8B8A8_UNORM analog (`Render.cpp:292`); 4x cheaper host pulls.
    frame_uint8: bool = False
    # Borderless-fullscreen resolution (`Render.cpp:287-413`): the
    # headless stand-in for the display's native mode. Flipping
    # `AppConfig.fullscreen` live drains and rebuilds the render engine
    # at this resolution (`Particles.cpp:458-463,488-509`).
    fullscreen_width: int = 1920
    fullscreen_height: int = 1080

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def resolved(self, fullscreen: bool) -> "RenderConfig":
        """The config the render engine should actually run at: this one,
        or the fullscreen-resolution variant of it when the runtime
        fullscreen toggle is on (the swap-chain rebuild analog)."""
        if not fullscreen:
            return self
        return dataclasses.replace(
            self, width=self.fullscreen_width, height=self.fullscreen_height
        )


@dataclasses.dataclass
class AppConfig:
    """Runtime-mutable application knobs.

    Field names intentionally track the reference's CLI flags
    (`Particles.cpp:251-267`): numparticles, numsim, numcopy, numdraw, size,
    intensity, nogui, novsync, fullscreen, noext.
    """

    num_particles: int = C.DEFAULT_NUM_PARTICLES
    # Decoupled pipeline-stage counts (`Particles.cpp:265-267`): number of
    # particles simulated / transferred / drawn each frame. None = linked to
    # num_particles (the GUI "link" toggle, `Particles.cpp:379-394`).
    num_sim: Optional[int] = None
    num_copy: Optional[int] = None
    num_draw: Optional[int] = None
    linked: bool = True

    particle_size: float = C.INITIAL_PARTICLE_SIZE
    particle_intensity: float = C.INITIAL_PARTICLE_INTENSITY

    gui: bool = True
    vsync: bool = True
    # -novsync dispatch-ahead bound: at most this many frames in flight
    # before the host blocks on the oldest (the latency-waitable swapchain's
    # SetMaximumFrameLatency, `Render.cpp:298-308`).
    max_frame_latency: int = 2
    fullscreen: bool = False
    # The Intel command-queue throttle extension analog: request
    # max-performance scheduling for the compute role (ExtensionHelper.h:138):
    # compile the step with XLA's latency-hiding scheduler
    # (utils/extension.py).
    use_queue_extension: bool = True

    def resolved_counts(self) -> Tuple[int, int, int]:
        """(num_sim, num_copy, num_draw) with link semantics applied.

        Linked mode tracks the Rendered slider (`Particles.cpp:388-392`:
        copied and simulated counts snap to the rendered count while the
        link checkbox is on); an unset rendered count means everything.
        """
        if self.linked:
            n = (
                min(self.num_draw, self.num_particles)
                if self.num_draw is not None
                else self.num_particles
            )
            return n, n, n
        n = self.num_particles
        return (
            min(self.num_sim if self.num_sim is not None else n, n),
            min(self.num_copy if self.num_copy is not None else n, n),
            min(self.num_draw if self.num_draw is not None else n, n),
        )
