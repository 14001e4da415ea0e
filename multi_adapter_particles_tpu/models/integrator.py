"""Jitted integrators over SoA ParticleState.

The reference's `Compute::Simulate` dispatch (`Compute.cpp:1009-1055`) becomes
a pure function `state -> state` under `jax.jit` with donated buffers: the
ping-pong pair of UAVs (`Compute.h:80,106-108`) is realized by XLA aliasing
the donated input storage for the output.

Force models:
- `central_well_accel`: the shipped CSMain math (`nBodyGravityCS.hlsl:92-101`).
- `all_pairs_accel`: the O(N^2) bodyBodyInteraction sum
  (`nBodyGravityCS.hlsl:44-57`) in pure XLA (batched over j-tiles via scan);
  the Triton kernel lives in `ops/allpairs.py`, and `ops/dispatch.py`
  chooses between them per device.

The `num_sim` decoupling knob (`Particles.cpp:265`, `Compute.cpp:1041`:
dispatch ceil(numSim/64) groups, the rest of the buffer is left stale) is
reproduced with a lane mask: particles >= num_sim keep their old state
bit-exactly.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu import constants as C
from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models.state import ParticleState

Array = jax.Array


# ---------------------------------------------------------------------------
# Force models (SoA: pos [4, Np] -> accel [3, Np])
# ---------------------------------------------------------------------------
def central_well_accel(
    position: Array, mass: float, softening_squared: float
) -> Array:
    """accel = r * (-mass / (|r|^2 + eps^2)^{3/2}), r = pos.xyz
    (`nBodyGravityCS.hlsl:92-101`)."""
    r = position[:3]
    dist_sqr = jnp.sum(r * r, axis=0) + jnp.float32(softening_squared)
    inv_dist = -jax.lax.rsqrt(dist_sqr)
    s = jnp.float32(mass) * (inv_dist * inv_dist * inv_dist)
    return r * s


def all_pairs_accel(
    position: Array,
    mass: float,
    softening_squared: float,
    interaction_scale: float = 1.0,
    mask: Optional[Array] = None,
    j_tile: int = 1024,
    sources: Optional[Array] = None,
) -> Array:
    """accel_i = sum_j (p_j - p_i) * mass*scale / (|p_j - p_i|^2 + eps^2)^{3/2}.

    Pure-XLA blocked formulation: scan over j-tiles so the [Np, j_tile]
    pairwise planes stay small enough for XLA to fuse and keep resident.
    `mask` (float 0/1 per j) excludes padding particles from the sum.
    `sources` ([4, Nj], default = position) selects the j-side bodies — the
    split form used by the multi-chip ring stages.
    Self-interaction contributes exactly zero (r_ii = 0), matching the
    upstream tiled shader which does not special-case i == j.
    """
    p = position[:3]  # [3, Np] targets
    src = p if sources is None else sources[:3]
    n = src.shape[1]
    if n % j_tile != 0:
        j_tile = n  # fall back to a single tile for odd sizes (tests)
    num_tiles = n // j_tile
    if mask is None:
        mask = jnp.ones((n,), dtype=p.dtype)
    scale = jnp.float32(mass) * jnp.float32(interaction_scale)

    p_tiles = src.reshape(3, num_tiles, j_tile)
    m_tiles = mask.reshape(num_tiles, j_tile)

    def body(acc, tile):
        pj, mj = tile  # pj [3, Tj], mj [Tj]
        # pairwise deltas, broadcast: [3, Np, Tj]
        dx = pj[0][None, :] - p[0][:, None]
        dy = pj[1][None, :] - p[1][:, None]
        dz = pj[2][None, :] - p[2][:, None]
        d2 = dx * dx + dy * dy + dz * dz + jnp.float32(softening_squared)
        inv = jax.lax.rsqrt(d2)
        s = (inv * inv * inv) * mj[None, :]  # mask kills padding columns
        ax = jnp.sum(dx * s, axis=1)
        ay = jnp.sum(dy * s, axis=1)
        az = jnp.sum(dz * s, axis=1)
        return acc + jnp.stack([ax, ay, az]), None

    # derive from p (not a fresh constant) so the varying-manual-axes type
    # is right when this runs inside shard_map (scan carry must match)
    acc0 = p * jnp.zeros((), dtype=p.dtype)
    acc, _ = jax.lax.scan(
        body, acc0, (jnp.moveaxis(p_tiles, 1, 0), m_tiles)
    )
    return acc * scale


# ---------------------------------------------------------------------------
# Euler tail (shared by all force models; nBodyGravityCS.hlsl:103-108)
# ---------------------------------------------------------------------------
def euler_update(
    position: Array,
    velocity: Array,
    accel: Array,
    dt: float,
    damping: float,
) -> tuple[Array, Array]:
    """v += a*dt; v *= damping; p += v*dt; pos.w = |a|."""
    vel = (velocity + accel * jnp.float32(dt)) * jnp.float32(damping)
    pos_xyz = position[:3] + vel * jnp.float32(dt)
    accel_mag = jnp.sqrt(jnp.sum(accel * accel, axis=0))
    new_position = jnp.concatenate([pos_xyz, accel_mag[None, :]], axis=0)
    return new_position, vel


def _apply_num_sim_mask(
    new_pos: Array, new_vel: Array, old: ParticleState, num_sim: Optional[int]
) -> ParticleState:
    """Freeze particles beyond num_sim, like a short dispatch.

    The reference dispatches whole 64-thread groups — ceil(numSim/64)
    (`Compute.cpp:1041`, BLOCK_SIZE `defines.h:37`) — so the effective count
    rounds UP to the next BLOCK_SIZE multiple; reproduced exactly here."""
    if num_sim is None:
        return ParticleState(new_pos, new_vel)
    num_sim = -(-int(num_sim) // C.BLOCK_SIZE) * C.BLOCK_SIZE
    idx = jnp.arange(new_pos.shape[-1])
    live = idx < num_sim
    pos = jnp.where(live[None, :], new_pos, old.position)
    vel = jnp.where(live[None, :], new_vel, old.velocity)
    return ParticleState(pos, vel)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------
def make_accel_fn_for(
    config: SimConfig, all_pairs_impl: Optional[str] = None
) -> Callable[[Array], Array]:
    """The run's own accel function (position [4, Np] -> accel [3, Np]) —
    exactly the force `make_step` applies each frame. Shared with the
    diagnostics probe so the half-kick velocity sync can reuse the
    dynamics force (the physically-right de-stagger: stored velocities
    are staggered by the APPLIED force) instead of recomputing the
    gauge's tree force. `all_pairs_impl` ("xla" | "triton"; None = what
    `ops/dispatch.all_pairs_impl` picks for the default device) selects
    the all-pairs implementation."""
    if config.force_model == "central_well":
        return functools.partial(
            central_well_accel,
            mass=config.mass,
            softening_squared=config.softening_squared,
        )
    if config.force_model == "pm_grid":
        from multi_adapter_particles_tpu.ops import pm

        return pm.make_accel_fn(
            mass=config.mass * config.interaction_scale,
            softening_squared=config.softening_squared,
            grid=config.pm_grid_size,
            box=config.pm_box,
        )
    if config.force_model == "p3m":
        from multi_adapter_particles_tpu.ops import p3m

        return p3m.make_accel_fn(
            mass=config.mass * config.interaction_scale,
            softening_squared=config.softening_squared,
            grid=config.pm_grid_size,
            box=config.pm_box,
            cutoff_cells=config.p3m_cutoff_cells,
            capacity=config.p3m_capacity,
            near_mode=config.p3m_near_mode,
            pair_budget=config.p3m_pair_budget,
        )

    from multi_adapter_particles_tpu.ops import dispatch

    if all_pairs_impl is None:
        all_pairs_impl = dispatch.all_pairs_impl()
    if all_pairs_impl != dispatch.XLA:
        from multi_adapter_particles_tpu.ops import allpairs

        return allpairs.make_accel_fn(
            mass=config.mass,
            softening_squared=config.softening_squared,
            interaction_scale=config.interaction_scale,
            interpret=all_pairs_impl == dispatch.TRITON_INTERPRET,
        )

    def accel_fn(position, _n=config.num_particles):
        m = (
            jnp.arange(position.shape[-1]) < _n
        ).astype(position.dtype)
        return all_pairs_accel(
            position,
            mass=config.mass,
            softening_squared=config.softening_squared,
            interaction_scale=config.interaction_scale,
            mask=m,
        )

    return accel_fn


def make_step(
    config: SimConfig,
    accel_fn: Optional[Callable[[Array], Array]] = None,
    donate: bool = True,
) -> Callable[[ParticleState], ParticleState]:
    """Build the jitted `state -> state` step for a SimConfig.

    `accel_fn` overrides the force model; it maps position [4, Np] ->
    accel [3, Np]. Default: `make_accel_fn_for(config)`.

    The returned callable takes (state, num_sim=None); num_sim is static
    (each distinct value compiles once — the analog of re-recording the
    dispatch with a different group count).
    """
    if accel_fn is None:
        accel_fn = make_accel_fn_for(config)

    def step(state: ParticleState, num_sim: Optional[int] = None) -> ParticleState:
        accel = accel_fn(state.position)
        new_pos, new_vel = euler_update(
            state.position, state.velocity, accel, config.dt, config.damping
        )
        return _apply_num_sim_mask(new_pos, new_vel, state, num_sim)

    if donate:
        return jax.jit(step, static_argnums=(1,), donate_argnums=(0,))
    return jax.jit(step, static_argnums=(1,))


def run(
    step_fn: Callable[[ParticleState], ParticleState],
    state: ParticleState,
    num_steps: int,
    num_sim: Optional[int] = None,
) -> ParticleState:
    """Host loop driving the step; dispatches stay async (no host blocks),
    mirroring the reference's fire-and-forget ExecuteCommandLists."""
    for _ in range(num_steps):
        state = step_fn(state, num_sim)
    return state
