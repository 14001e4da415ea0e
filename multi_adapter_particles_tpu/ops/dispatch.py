"""Which implementation of each op runs on a device, and how much memory
that device has.

Two ops have a hand-written kernel beside their plain XLA formulation:
the all-pairs force (`ops/allpairs.py`) and the splat composite
(`ops/composite.py`). Both kernels are Pallas kernels for the Triton
route and compile only for an NVIDIA GPU. On every other backend the
XLA formulation is the implementation and the kernel is never called.
The Pallas interpreter is reached only through the `interpret=`
argument of a kernel wrapper, which tests pass explicitly; it is never
a run-time fallback.

Call sites ask this module instead of testing a platform string
themselves, so the choice for each platform is made in one place.
"""

from __future__ import annotations

from typing import Iterable, Optional, Union

import jax

XLA = "xla"
TRITON = "triton"
# The Triton kernel run by the Pallas interpreter: only tests name it.
TRITON_INTERPRET = "triton-interpret"

# Stated device memory for backends that report none (the CPU test
# backend). A GPU must report its own: see `memory_limit_bytes`.
CPU_MEMORY_BYTES = 16 * 1024**3

Devices = Union[None, jax.Device, Iterable[jax.Device]]


def _devices(devices: Devices) -> list:
    if devices is None:
        return [jax.devices()[0]]
    if hasattr(devices, "platform"):  # one device
        return [devices]
    return list(devices)


def platform(devices: Devices = None) -> str:
    """The one platform of `devices` (default: JAX's first device); a mix
    of platforms is reported as "mixed", which selects no kernel."""
    kinds = {d.platform for d in _devices(devices)}
    return kinds.pop() if len(kinds) == 1 else "mixed"


def has_kernels(devices: Devices = None) -> bool:
    """True where this repository's Pallas kernels compile: NVIDIA GPUs."""
    return platform(devices) == "gpu"


def all_pairs_impl(devices: Devices = None) -> str:
    """Implementation of the all-pairs force on `devices`."""
    return TRITON if has_kernels(devices) else XLA


def composite_impl(devices: Devices = None) -> str:
    """Implementation of the renderer's depth-Q composite on `devices`."""
    return TRITON if has_kernels(devices) else XLA


def memory_limit_bytes(device: Optional[jax.Device] = None) -> int:
    """Device memory available to this process's arrays, from
    `memory_stats()["bytes_limit"]`. Only a backend that reports no
    memory statistics at all (the CPU) gets the stated
    `CPU_MEMORY_BYTES`; an accelerator that reports none is an error,
    because every size derived from it would be a guess."""
    dev = _devices(device)[0]
    try:
        stats = dev.memory_stats()
    except Exception:  # backends without the API
        stats = None
    limit = (stats or {}).get("bytes_limit")
    if limit:
        return int(limit)
    if dev.platform == "cpu":
        return CPU_MEMORY_BYTES
    raise RuntimeError(
        f"{dev.platform} device {dev} reports no memory_stats()['bytes_limit']"
    )
