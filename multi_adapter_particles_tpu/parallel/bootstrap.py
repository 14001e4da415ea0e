"""Multi-host / multi-process bootstrap for cluster-scale runs.

The reference is single-host multi-GPU; clusters add a layer it never
had: multiple host processes, each owning a subset of the devices,
coordinated over the inter-host network. This wrapper makes the rest of the framework work unchanged there:
after `initialize()`, `jax.devices()` is the GLOBAL device list, so
`make_mesh()` / `make_multislice_mesh()` and the sharded step build global
meshes; per-host data feeding is not needed (state is initialized on
device).

On a single host (this dev environment) `initialize()` is a no-op, so the
same entry script runs everywhere — the analog of the reference running
identically on 1-GPU and 2-GPU machines.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running under a multi-process
    launcher; no-op (returns False) in single-process runs.

    Explicit args override the environment (the
    JAX_COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID convention).
    """
    # Launched iff a coordinator is named (arg or env). Deliberately NOT
    # keyed on a worker-id variable: worker 0 carries id "0" and would be
    # indistinguishable from a plain single host — half-initialized
    # clusters hang at startup.
    launched = (
        coordinator_address is not None
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    if not launched:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def is_primary() -> bool:
    """True on the process that should own the render role / IO."""
    return jax.process_index() == 0


def local_render_device() -> jax.Device:
    """A render-role device owned by THIS process (the copy-queue target
    must be addressable to write frames from the primary host)."""
    return jax.local_devices()[0]
