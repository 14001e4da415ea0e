"""Mesh construction helpers.

One logical axis, `"particles"`: the only scalable dimension in this workload
(SURVEY §2.2 — there is no sequence/batch/expert axis). The mesh is 1-D so
`ppermute` rides neighbour links inside one host; multi-host layouts add
an outer axis, with the ring kept inside each host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "particles"
OUTER_AXIS = "slices"  # the inter-host dimension of multi-host layouts


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    n_devices: Optional[int] = None,
) -> Mesh:
    """1-D mesh over the given devices (default: all addressable)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def make_multislice_mesh(
    num_slices: int,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """2-D (slices, particles) mesh: the outer axis crosses host
    boundaries (inter-host network), the inner axis stays inside one host
    (intra-host links). The hierarchical ring in
    `make_sharded_step` keeps the high-rate block rotation on the inner
    axis and amortizes one slow outer rotation per full inner cycle."""
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    if len(devices) % num_slices:
        raise ValueError(
            f"{len(devices)} devices not divisible into {num_slices} slices"
        )
    per = len(devices) // num_slices
    arr = np.asarray(devices).reshape(num_slices, per)
    return Mesh(arr, (OUTER_AXIS, AXIS))


def mesh_devices(mesh: Mesh):
    return list(mesh.devices.ravel())


def particle_sharding(mesh: Mesh) -> NamedSharding:
    """SoA planes [C, Np] sharded along the particle (lane) axis; on a
    multi-slice mesh the particle dim shards over both axes (slice-major)."""
    if OUTER_AXIS in mesh.axis_names:
        return NamedSharding(mesh, P(None, (OUTER_AXIS, AXIS)))
    return NamedSharding(mesh, P(None, AXIS))


def particle_spec(mesh: Mesh) -> P:
    if OUTER_AXIS in mesh.axis_names:
        return P(None, (OUTER_AXIS, AXIS))
    return P(None, AXIS)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
