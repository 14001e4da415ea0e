"""Blocked all-pairs gravity force as a Pallas kernel for the Triton route.

This is the GPU shape the demo's lineage already had: Microsoft's
D3D12nBodyGravity stages tiles of bodies through groupshared memory while
each thread keeps one body's accumulator in registers, and sums
`bodyBodyInteraction` (`nBodyGravityCS.hlsl:44-57`) over every tile.

- One program per block of `block_i` targets. Its target coordinates
  stay in registers for the whole source loop.
- The program walks the sources in tiles of `block_j`. Each tile is
  loaded once per program; at 1M bodies the whole [4, N] source array is
  16 MB and stays resident in the 50 MB L2, so the loop reads L2, not
  device memory.
- The pair terms accumulate elementwise into [block_i, block_j] float32
  planes, which are summed over j once, after the loop: no cross-thread
  reduction inside the loop.
- There is no mask. Padding particles are parked at 1e9
  (`models/state.py`): a parked source adds O(1e-19) to a real target,
  and parked-parked pairs have r = 0, which contributes exactly zero, as
  does every self pair (the upstream shader never special-cases i == j
  either).

The plain XLA formulation is `models/integrator.all_pairs_accel`;
`ops/dispatch.all_pairs_impl` chooses between the two.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from multi_adapter_particles_tpu.models.state import PAD_POSITION

# Tile shape and launch parameters: the fastest of the launch shapes swept
# at 1M on an H100 (`chip_smoke.py --sweep`; PERF.md "Kernel decisions").
DEFAULT_BLOCK_I = 128
DEFAULT_BLOCK_J = 32
DEFAULT_NUM_WARPS = 8
DEFAULT_NUM_STAGES = 2


def _kernel(tgt_ref, src_ref, out_ref, *, num_j_blocks, block_j, eps2,
            mass_scale):
    xi = tgt_ref[0, :][:, None]          # [BI, 1]
    yi = tgt_ref[1, :][:, None]
    zi = tgt_ref[2, :][:, None]
    block_i = xi.shape[0]

    def body(j, acc):
        ax, ay, az = acc                 # each [BI, BJ]
        sl = pl.ds(j * block_j, block_j)
        dx = src_ref[0, sl][None, :] - xi
        dy = src_ref[1, sl][None, :] - yi
        dz = src_ref[2, sl][None, :] - zi
        d2 = dx * dx + dy * dy + dz * dz + jnp.float32(eps2)
        inv = jax.lax.rsqrt(d2)
        s = inv * inv * inv              # 1 / d^3 (mass applied once below)
        return ax + dx * s, ay + dy * s, az + dz * s

    zero = jnp.zeros((block_i, block_j), jnp.float32)
    ax, ay, az = jax.lax.fori_loop(0, num_j_blocks, body, (zero, zero, zero))
    m = jnp.float32(mass_scale)
    ax = jnp.sum(ax, axis=1) * m
    ay = jnp.sum(ay, axis=1) * m
    az = jnp.sum(az, axis=1) * m
    out_ref[0, :] = ax
    out_ref[1, :] = ay
    out_ref[2, :] = az
    out_ref[3, :] = jnp.sqrt(ax * ax + ay * ay + az * az)


def _pad_to(x: jax.Array, multiple: int) -> jax.Array:
    pad = (-x.shape[1]) % multiple
    if not pad:
        return x
    return jnp.concatenate(
        [x, jnp.full((x.shape[0], pad), PAD_POSITION, x.dtype)], axis=1
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mass", "softening_squared", "interaction_scale", "block_i",
        "block_j", "num_warps", "num_stages", "interpret",
    ),
)
def all_pairs_accel_triton(
    position: jax.Array,
    mass: float,
    softening_squared: float,
    interaction_scale: float = 1.0,
    sources: jax.Array | None = None,
    block_i: int = DEFAULT_BLOCK_I,
    block_j: int = DEFAULT_BLOCK_J,
    num_warps: int = DEFAULT_NUM_WARPS,
    num_stages: int = DEFAULT_NUM_STAGES,
    interpret: bool = False,
) -> jax.Array:
    """position [4, Ni] -> [4, Ni] (ax, ay, az, |a|), all float32.

    `sources` ([4, Nj], default = position) selects the j-side bodies —
    the split form the sharded schedules use. Any Ni and Nj: both sides
    are padded with parked particles to whole blocks. `interpret=True`
    runs the kernel in the Pallas interpreter (tests on the CPU)."""
    if sources is None:
        sources = position
    ni = position.shape[1]
    tgt = _pad_to(position[:3].astype(jnp.float32), block_i)
    src = _pad_to(sources[:3].astype(jnp.float32), block_j)
    # a fourth row keeps every block a power of two in height
    tgt = jnp.concatenate([tgt, jnp.zeros_like(tgt[:1])], axis=0)
    src = jnp.concatenate([src, jnp.zeros_like(src[:1])], axis=0)
    ni_pad, nj_pad = tgt.shape[1], src.shape[1]
    # inside shard_map the result varies over the mesh axes its inputs do
    vma = jax.typeof(tgt).vma | jax.typeof(src).vma

    kernel = functools.partial(
        _kernel,
        num_j_blocks=nj_pad // block_j,
        block_j=block_j,
        eps2=float(softening_squared),
        mass_scale=float(mass) * float(interaction_scale),
    )
    out = pl.pallas_call(
        kernel,
        grid=(ni_pad // block_i,),
        in_specs=[
            pl.BlockSpec((4, block_i), lambda i: (0, i)),
            pl.no_block_spec,
        ],
        out_specs=pl.BlockSpec((4, block_i), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((4, ni_pad), jnp.float32, vma=vma),
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        cost_estimate=pl.CostEstimate(
            flops=int(ni_pad) * int(nj_pad) * 20,
            bytes_accessed=int(nj_pad) * 16 * (ni_pad // block_i) + ni_pad * 32,
            transcendentals=int(ni_pad) * int(nj_pad),
        ),
        interpret=interpret,
        backend="triton",
        name="all_pairs_accel",
    )(tgt, src)
    return out[:, :ni]


def make_accel_fn(
    mass: float,
    softening_squared: float,
    interaction_scale: float = 1.0,
    interpret: bool = False,
):
    """Adapter matching the integrator's accel_fn signature
    (position [4, Np] -> accel [3, Np])."""

    def accel_fn(position: jax.Array) -> jax.Array:
        return all_pairs_accel_triton(
            position,
            mass=mass,
            softening_squared=softening_squared,
            interaction_scale=interaction_scale,
            interpret=interpret,
        )[:3]

    return accel_fn
