"""Debug validation layer — the D3D12 debug-layer analog.

The reference enables the D3D12 debug layer + DXGI debug factory in debug
builds (`Particles.cpp:80-99`) to catch API misuse and resource hazards;
the fence protocol's single-writer rules are its correctness argument
(`Render.cpp:38-85`). The JAX analogs of those hazard classes:

- **NaN/Inf contamination** (the math blowing up silently) ->
  `jax.debug_nans` plus explicit per-frame finiteness asserts;
- **donation aliasing hazards** (reading a buffer whose storage was
  re-used — the UAV-overwrite race analog) -> donation disabled in debug
  mode so stale reads cannot be masked by aliasing, plus explicit
  `is_deleted` checks on the double-buffer hand-off.

Enable with `debug_mode()` (context manager) or the CLI `-debug` flag.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import jax
import numpy as np


class DebugValidationError(AssertionError):
    pass


@contextlib.contextmanager
def debug_mode():
    """Enable jax NaN debugging for the duration."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def validate_state(state, num_particles: Optional[int] = None, where: str = ""):
    """Assert the particle state is finite and live (not donated away)."""
    for name in ("position", "velocity"):
        arr = getattr(state, name)
        if arr.is_deleted():
            raise DebugValidationError(
                f"{where}: {name} buffer was donated/deleted while still "
                "referenced — double-buffer hand-off violation"
            )
        host = np.asarray(jax.device_get(arr))
        if num_particles is not None:
            host = host[:, :num_particles]
        if not np.isfinite(host).all():
            bad = int((~np.isfinite(host)).sum())
            raise DebugValidationError(
                f"{where}: {name} has {bad} non-finite values"
            )


def validate_handoff(display_positions) -> None:
    """The render side must never hold a deleted (donated) buffer."""
    if display_positions is not None and display_positions.is_deleted():
        raise DebugValidationError(
            "display positions were donated into the next step before the "
            "draw consumed them — fence-order violation analog"
        )
