"""Adapter enumeration and role assignment.

The reference enumerates DXGI hardware adapters, skips software adapters,
and assigns roles by a UMA heuristic: integrated (UMA) adapter gets the
compute role, the discrete adapter renders; same adapter for both roles
selects single-adapter async-compute mode (`Particles.cpp:95-122,212-243`).

The JAX analog enumerates jax devices across *platforms*: every GPU is an
adapter, and the host CPU device is kept in the list as the weak
"integrated" analog (useful for exercising the cross-device transfer path
without a second card; the reference's WARP/software filter maps to
de-prioritizing, not hiding, the CPU device). Role assignment:

- default with 2+ accelerators: SPLIT — compute on the first card, render
  on the second (the headline multi-adapter mode, on by default like the
  reference whenever two adapters exist);
- default with one accelerator: both roles share it -> async-compute mode
  (one card simulating and rendering, zero copies — `README.md:14`);
- no accelerator (JAX found only the CPU): both roles run on the CPU, and
  `enumerate_adapters` says so on stderr — a CUDA set-up that failed to
  initialise must not pass silently for a GPU run;
- any explicit pair of distinct devices -> split mode with a positions
  transfer each frame (the cross-adapter shared heap + copy queue analog).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax


@dataclasses.dataclass(frozen=True)
class AdapterInfo:
    """One selectable adapter (`DXGI_ADAPTER_DESC1` analog)."""

    index: int
    device: jax.Device
    platform: str        # 'gpu' | 'cpu'
    description: str

    @property
    def is_accelerator(self) -> bool:
        return self.platform != "cpu"

    # The UMA bit drove the reference's role heuristic (AdapterShared.h:93-101):
    # UMA = shares memory with the host. On this stack the CPU device is the
    # only "UMA" adapter; GPU memory is discrete.
    @property
    def is_uma(self) -> bool:
        return self.platform == "cpu"


def enumerate_adapters(include_cpu: bool = True) -> List[AdapterInfo]:
    """All selectable devices, accelerators first (`Particles.cpp:95-122`)."""
    adapters: List[AdapterInfo] = []
    seen = set()

    def add(dev: jax.Device):
        key = (dev.platform, dev.id)
        if key in seen:
            return
        seen.add(key)
        adapters.append(
            AdapterInfo(
                index=len(adapters),
                device=dev,
                platform=dev.platform,
                description=f"{dev.device_kind} (id {dev.id})",
            )
        )

    for dev in jax.devices():
        add(dev)
    if not any(a.is_accelerator for a in adapters):
        import sys

        print("devices: JAX found no accelerator; running on the CPU",
              file=sys.stderr, flush=True)
    if include_cpu:
        try:
            for dev in jax.devices("cpu"):
                add(dev)
        except RuntimeError:
            pass  # no CPU backend registered
    if not adapters:
        raise RuntimeError("no jax devices found")  # Particles.cpp:140 analog
    return adapters


def assign_adapters(
    adapters: Sequence[AdapterInfo],
    compute_index: Optional[int] = None,
    render_index: Optional[int] = None,
) -> Tuple[AdapterInfo, AdapterInfo]:
    """Pick (compute, render) adapters.

    Reference heuristic (`Particles.cpp:212-243`): whenever TWO adapters
    exist, split the roles (UMA adapter computes, discrete renders) — the
    multi-adapter mode is the default, not opt-in. Mapped here: with 2+
    accelerators of the leading platform, compute takes the first and
    render the second (chips are symmetric, so no UMA preference applies);
    with one accelerator, both roles share it (async-compute mode — the
    reference on a single-GPU machine). The CPU "UMA" device never wins a
    default role next to an accelerator (orders slower), only explicit
    selection.
    """
    pool = [a for a in adapters if a.is_accelerator] or list(adapters)
    same_platform = [a for a in pool if a.platform == pool[0].platform]
    default_compute = same_platform[0]
    default_render = (
        same_platform[1] if len(same_platform) > 1 else same_platform[0]
    )
    compute = (
        adapters[compute_index] if compute_index is not None else default_compute
    )
    render = (
        adapters[render_index] if render_index is not None else default_render
    )
    return compute, render


def mode_banner(compute: AdapterInfo, render: AdapterInfo) -> str:
    """The GUI status line (`Particles.cpp:354-368`)."""
    if compute.device == render.device:
        return "Single Adapter with Async Compute"
    if compute.is_uma or not render.is_uma:
        # split across devices with the weak one computing = the demo's
        # "Good" configuration
        return "Good: Multi-Adapter Split (compute/render on separate devices)"
    return "PERFORMANCE ISSUE: Compute is not UMA"
