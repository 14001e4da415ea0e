"""Distributed free-space FFT convolution: slab/pencil decomposition.

Scales the PM field solve past one-device grids (G >= 256: the doubled
spectrum alone is [2G, 2G, G+1] c64 = 540 MB) by decomposing over the
mesh's inner (intra-host) axis, the standard HPC pencil pipeline re-expressed
with XLA collectives:

    partial deposits --psum_scatter--> z-slabs [G/D, G, G]
    local rfft(x) + fft(y)            [G/D, 2G, G+1]
    all_to_all (y split, z concat)    [G, 2G/D, G+1]      (transpose)
    local fft(z, padded)              [2G, 2G/D, G+1]
    x kernel slab (pre-sharded)       pointwise
    local ifft(z) + slice             [G, 2G/D, G+1]
    all_to_all (z split, y concat)    [G/D, 2G, G+1]      (transpose back)
    local ifft(y) + irfft(x) + slice  [G/D, G, G]
    all_gather                        [G, G, G] phi on every device

Each device transforms 1/D of the pencils in every stage and holds 1/D
of the kernel spectrum; the two all_to_alls stay inside the host. The axis-pruned
zero-padding of `ops/pm._convolve_pruned` carries over: forward axes
pad lazily (fft(n=2G) on G-tall input) and inverse axes slice as soon
as they are done.

The kernel slab is precomputed host-side once per (grid, box, eps2)
and placed with `PartitionSpec(None, AXIS, None)` so shard_map hands
each device exactly its y-columns (`make_kernel_slabs`).

Numerics: per-axis FFTs act on independent pencils, so the distributed
result matches the single-device `_convolve_pruned` up to collective
reduction order in the deposit psum (tolerance, not bitwise — pinned by
`tests/test_dist_fft.py`).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multi_adapter_particles_tpu.parallel.mesh import AXIS


def supports(grid: int, n_inner: int) -> bool:
    """Slab decomposition needs both G and 2G to split evenly over the
    inner axis (and more than one device to be worth anything)."""
    return n_inner > 1 and grid % n_inner == 0 and (2 * grid) % n_inner == 0


def make_kernel_slabs(
    mesh: Mesh, grid: int, box: float, softening_squared: float
) -> jax.Array:
    """Host-precomputed kernel spectrum, sharded along its y axis.

    Same tabulation as `ops/pm._potential_kernel_rfft` (phi(r) =
    -(|r|²+eps²)^(-1/2) on the doubled grid, min-image offsets), built in
    NumPy once at step-build time — [2G, 2G, G+1] c64 lives briefly on
    the host and lands on the mesh as D slabs of [2G, 2G/D, G+1]."""
    g2 = 2 * grid
    h = box / grid
    m = np.arange(g2)
    off = (((m + grid) % g2) - grid).astype(np.float32) * h
    rz = off[:, None, None]
    ry = off[None, :, None]
    rx = off[None, None, :]
    d2 = rx * rx + ry * ry + rz * rz + np.float32(softening_squared)
    kernel = np.fft.rfftn(-1.0 / np.sqrt(d2)).astype(np.complex64)
    return jax.device_put(kernel, NamedSharding(mesh, P(None, AXIS, None)))


def convolve_slab(
    rho_partial: jax.Array,    # [G, G, G] THIS device's partial deposit
    kernel_slab: jax.Array,    # [2G, 2G/D, G+1] this device's y-columns
    grid: int,
    axis: str = AXIS,
) -> jax.Array:
    """Inside shard_map: partial deposits -> full convolved phi [G, G, G]
    replicated on every device of `axis`. See module docstring."""
    g = grid
    g2 = 2 * g
    # partial per-device deposits -> z-slabs of the SUMMED density
    slab = jax.lax.psum_scatter(
        rho_partial, axis, scatter_dimension=0, tiled=True
    )                                                   # [G/D, G, G]
    f = jnp.fft.rfft(slab, n=g2, axis=2)                # [G/D, G, G+1]
    f = jnp.fft.fft(f, n=g2, axis=1)                    # [G/D, 2G, G+1]
    f = jax.lax.all_to_all(
        f, axis, split_axis=1, concat_axis=0, tiled=True
    )                                                   # [G, 2G/D, G+1]
    f = jnp.fft.fft(f, n=g2, axis=0)                    # [2G, 2G/D, G+1]
    f = f * kernel_slab
    f = jnp.fft.ifft(f, axis=0)[:g]                     # [G, 2G/D, G+1]
    f = jax.lax.all_to_all(
        f, axis, split_axis=0, concat_axis=1, tiled=True
    )                                                   # [G/D, 2G, G+1]
    f = jnp.fft.ifft(f, axis=1)[:, :g]                  # [G/D, G, G+1]
    phi_slab = jnp.fft.irfft(f, n=g2, axis=2)[:, :, :g]  # [G/D, G, G]
    return jax.lax.all_gather(phi_slab, axis, axis=0, tiled=True)
