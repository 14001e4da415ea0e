"""Sharded simulation step: shard_map + ring position exchange between devices.

The copy-queue-overlaps-compute idea (`Render.cpp:789-831`: transfer of frame
N's results runs while N-1 draws and N+1 simulates) becomes, inside one chip
step, the ring schedule: at stage s every device computes partial forces from
the position block it holds while `ppermute` already rotates that block to
the neighbor — the transfer hides behind the O(n_local * n_block) force math.
After D stages every device has accumulated forces from all N bodies.

Per-device force math goes through the same implementation as one device
(`ops/dispatch.all_pairs_impl`: the Triton kernel on GPUs, XLA elsewhere),
so the mesh path is a composition, not a re-implementation.

The central-well model needs no communication at all (embarrassingly
particle-parallel): its sharded step is just the single-chip step under a
sharding constraint — XLA inserts zero collectives.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models import integrator
from multi_adapter_particles_tpu.models.state import ParticleState
from multi_adapter_particles_tpu.ops import allpairs, dispatch
from multi_adapter_particles_tpu.parallel import dist_fft
from multi_adapter_particles_tpu.parallel.mesh import (
    AXIS,
    OUTER_AXIS,
    particle_sharding,
    particle_spec,
)


def shard_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    """Place a state pytree on the mesh, particle-axis sharded."""
    sh = particle_sharding(mesh)
    return ParticleState(
        jax.device_put(state.position, sh),
        jax.device_put(state.velocity, sh),
    )


def _partial_accel_fn(cfg: SimConfig, impl: str) -> Callable:
    """(targets [4, ni], sources [4, nj]) -> accel [3, ni]."""
    if impl != dispatch.XLA:
        def f(targets, sources):
            return allpairs.all_pairs_accel_triton(
                targets,
                mass=cfg.mass,
                softening_squared=cfg.softening_squared,
                interaction_scale=cfg.interaction_scale,
                sources=sources,
                interpret=impl == dispatch.TRITON_INTERPRET,
            )[:3]
        return f

    def f(targets, sources):
        return integrator.all_pairs_accel(
            targets,
            mass=cfg.mass,
            softening_squared=cfg.softening_squared,
            interaction_scale=cfg.interaction_scale,
            sources=sources,
        )
    return f


def make_sharded_step(
    cfg: SimConfig,
    mesh: Mesh,
    all_pairs_impl: Optional[str] = None,
    donate: bool = True,
    bit_stable: Optional[bool] = None,
) -> Callable[[ParticleState], ParticleState]:
    """Build the jitted multi-chip `state -> state` step.

    State must be particle-sharded on `mesh` (see `shard_state`); padded
    count must divide by the mesh size. Padding particles are parked at 1e9
    (forces on/from them are ~0, see ops/allpairs.py docstring), so shards
    need no mask exchange.

    `bit_stable` (all-pairs only; default True) chooses the source-exchange
    schedule:

    - True: all-gather the positions, then run the SAME force kernel and
      tiling as single-chip against the full [4, N] source set. Every
      device reduces sources in identical global order, so trajectories
      are BITWISE identical across any mesh size — including 1 — and
      across live re-sharding (SURVEY §7 hard part 5: "bit-stable
      trajectories across re-sharding"). The gather moves O(N) bytes
      between devices up front, small next to the O(N²/D) force math at
      any size this model runs.
    - False: the rotating ppermute ring (the copy-queue-overlap analog,
      `Render.cpp:789-831`): blocks stream neighbor-to-neighbor with the
      transfer hidden behind each stage's force math. Accumulation order
      then depends on the device count (ring reassociation), so
      trajectories across different mesh sizes agree only to fp32
      tolerance. Worth it only when per-stage transfer is comparable to
      per-stage compute (bandwidth-bound force models).
    """
    ndev = mesh.devices.size
    multislice = OUTER_AXIS in mesh.axis_names
    n_inner = mesh.shape[AXIS]
    n_outer = mesh.shape[OUTER_AXIS] if multislice else 1
    if all_pairs_impl is None:
        all_pairs_impl = dispatch.all_pairs_impl(mesh.devices.ravel())
    if bit_stable is None:
        bit_stable = True
    partial_accel = _partial_accel_fn(cfg, all_pairs_impl)
    inner_perm = [(i, (i + 1) % n_inner) for i in range(n_inner)]
    outer_perm = [(i, (i + 1) % n_outer) for i in range(n_outer)]

    def gathered_sources(position):
        """Full [4, N] source set in global particle order on every device:
        inner (intra-host) gather concatenates the shards of this slice, the
        outer (inter-host) gather concatenates slices — matching the slice-major layout
        of `particle_sharding`."""
        src = position
        if n_inner > 1:
            src = jax.lax.all_gather(src, AXIS, axis=1, tiled=True)
        if multislice and n_outer > 1:
            src = jax.lax.all_gather(src, OUTER_AXIS, axis=1, tiled=True)
        return src

    def ring_cycle(position, acc, block, final: bool):
        """One full inner-ring cycle: consume n_inner blocks, rotating over
        the intra-host axis; the ppermute is issued BEFORE the force math so the
        transfer overlaps compute (async collective). Unless `final`, one
        last rotation returns every block to its starting slot so the next
        outer (inter-host) hop ships the right set."""
        if n_inner > 1:
            def body(carry, _):
                acc, blk = carry
                nxt = jax.lax.ppermute(blk, AXIS, inner_perm)
                acc = acc + partial_accel(position, blk)
                return (acc, nxt), None

            (acc, block), _ = jax.lax.scan(
                body, (acc, block), None, length=n_inner - 1
            )
        acc = acc + partial_accel(position, block)
        if not final and n_inner > 1:
            block = jax.lax.ppermute(block, AXIS, inner_perm)  # home again
        return acc, block

    use_dist_fft = (
        cfg.force_model == "pm_grid"
        and cfg.pm_distributed_fft
        and dist_fft.supports(cfg.pm_grid_size, n_inner)
    )

    def pm_accel_sharded(position, kernel_slab):
        """PM on the mesh: every shard deposits its own particles, then

        - default: the [G³] grids all-reduce (psum — the grid is tiny
          next to particle state) and each shard solves the identical FFT
          locally and interpolates its own particles — redundant solves
          beat shipping fields for small grids;
        - `pm_distributed_fft`: the slab-decomposed pipeline
          (`parallel/dist_fft.py`) — each device transforms 1/D of the
          pencils and holds 1/D of the kernel spectrum; for G >= 256
          grids that do not fit (or pay too much) per device.
        """
        from multi_adapter_particles_tpu.ops import pm

        rho = pm.deposit_cic(position, cfg.pm_grid_size, cfg.pm_box)
        g_const = cfg.mass * cfg.interaction_scale
        if use_dist_fft:
            if multislice:
                rho = jax.lax.psum(rho, OUTER_AXIS)
            phi = dist_fft.convolve_slab(
                rho, kernel_slab, cfg.pm_grid_size, AXIS
            ) * jnp.float32(g_const)
            acc32 = pm._grad_pack(phi, cfg.pm_grid_size, cfg.pm_box)
            return pm._interp(acc32, position, cfg.pm_grid_size, cfg.pm_box)
        rho = jax.lax.psum(rho, AXIS)
        if multislice:
            rho = jax.lax.psum(rho, OUTER_AXIS)
        return pm.solve_and_gather(
            rho, position,
            grid=cfg.pm_grid_size, box=cfg.pm_box,
            g_const=g_const,
            softening_squared=cfg.softening_squared,
        )

    def p3m_accel_sharded(position):
        """P³M on the mesh: the far field parallelizes like PM (per-shard
        deposit, grid psum, local long-solve + interp of LOCAL targets);
        the near field needs global neighbor sources, so every device
        bins the GATHERED positions. TREE mode partitions target blocks
        round-robin over the mesh (1/D of the sweep each) and psums the
        partial fields; the SLOT sweep stays redundant per device — its
        grids are small (few-ms sweeps) and the redundancy matches the
        redundant local FFT solves the default PM path takes."""
        from multi_adapter_particles_tpu.ops import p3m, pm

        g_const = cfg.mass * cfg.interaction_scale
        grid, box = cfg.pm_grid_size, cfg.pm_box
        r_c = cfg.p3m_cutoff_cells * box / grid
        gn = max(int(box // r_c), 1)

        rho = pm.deposit_cic(position, grid, box)
        rho = jax.lax.psum(rho, AXIS)
        if multislice:
            rho = jax.lax.psum(rho, OUTER_AXIS)
        acc32 = p3m._accel_rows_long(rho, grid, box, g_const, r_c)
        a_far = pm._interp(acc32, position, grid, box)

        full = gathered_sources(position)
        n_loc = position.shape[1]
        shard = jax.lax.axis_index(AXIS)
        if multislice:
            shard = jax.lax.axis_index(OUTER_AXIS) * n_inner + shard
        if cfg.p3m_near_mode == "tree":
            from multi_adapter_particles_tpu.ops.treeforce import (
                near_field_tree,
            )

            # target blocks partitioned round-robin over the mesh: each
            # device sweeps only the pair list rows it owns (1/D of the
            # near work — the redundant-sweep v1 stance dropped for tree
            # mode) and the partial fields psum back to the full near
            # correction (each block owned exactly once).
            n_dev = n_inner * n_outer

            def owner(ids):
                return jax.lax.rem(ids, jnp.int32(n_dev)) == shard

            a_near_full, _overflow = near_field_tree(
                full, box, g_const, cfg.softening_squared, r_c, gn,
                pair_budget=cfg.p3m_pair_budget,
                sub_pair_budget=cfg.p3m_sub_pair_budget,
                block_owner_fn=owner,
            )
            a_near_full = jax.lax.psum(a_near_full, AXIS)
            if multislice:
                a_near_full = jax.lax.psum(a_near_full, OUTER_AXIS)
        else:  # "slots" / "auto" (the data-free default)
            a_near_full, _overflow = p3m.near_field_correction(
                full, box, g_const, cfg.softening_squared, r_c, gn,
                cfg.p3m_capacity,
            )
        a_near = jax.lax.dynamic_slice_in_dim(
            a_near_full, shard * n_loc, n_loc, axis=1
        )
        return a_far + a_near

    def local_step(position, velocity, kernel_slab, num_sim: Optional[int]):
        # position [4, n_loc], velocity [3, n_loc] — per-device blocks;
        # kernel_slab is this device's y-columns of the kernel spectrum
        # (distributed-FFT PM only, else a placeholder scalar).
        old_position, old_velocity = position, velocity
        if cfg.force_model == "central_well":
            accel = integrator.central_well_accel(
                position, cfg.mass, cfg.softening_squared
            )
        elif cfg.force_model == "pm_grid":
            accel = pm_accel_sharded(position, kernel_slab)
        elif cfg.force_model == "p3m":
            accel = p3m_accel_sharded(position)
        elif bit_stable:
            # Bit-stable schedule: same kernel, same source order, same
            # tiling as single-chip — trajectories identical across mesh
            # sizes to the last bit.
            accel = partial_accel(position, gathered_sources(position))
        else:
            # Hierarchical ring (single-slice: plain ring): each outer
            # stage rotates the working block set one slice between hosts,
            # and that one slow hop amortizes over a full inner cycle.
            zero = position[:3] * jnp.zeros((), position.dtype)
            acc, block = ring_cycle(
                position, zero, position, final=(n_outer == 1)
            )
            for s in range(n_outer - 1):
                block = jax.lax.ppermute(block, OUTER_AXIS, outer_perm)
                acc, block = ring_cycle(
                    position, acc, block, final=(s == n_outer - 2)
                )
            accel = acc
        new_pos, new_vel = integrator.euler_update(
            position, velocity, accel, cfg.dt, cfg.damping
        )
        if num_sim is not None:
            # Freeze particles >= num_sim (short-dispatch analog,
            # Compute.cpp:1041: whole 64-thread groups, so round UP to
            # BLOCK_SIZE) using this shard's *global* indices.
            from multi_adapter_particles_tpu import constants as C

            eff = -(-int(num_sim) // C.BLOCK_SIZE) * C.BLOCK_SIZE
            n_loc = position.shape[1]
            shard = jax.lax.axis_index(AXIS)
            if multislice:
                shard = jax.lax.axis_index(OUTER_AXIS) * n_inner + shard
            gidx = shard * n_loc + jnp.arange(n_loc)
            live = (gidx < eff)[None, :]
            new_pos = jnp.where(live, new_pos, old_position)
            new_vel = jnp.where(live, new_vel, old_velocity)
        return new_pos, new_vel

    if use_dist_fft:
        kernel_arg = dist_fft.make_kernel_slabs(
            mesh, cfg.pm_grid_size, cfg.pm_box, cfg.softening_squared
        )
        kernel_spec = P(None, AXIS, None)
    else:
        kernel_arg = jnp.zeros((), jnp.float32)  # placeholder, replicated
        kernel_spec = P()

    def make(num_sim: Optional[int]):
        spec = particle_spec(mesh)
        return jax.shard_map(
            functools.partial(local_step, num_sim=num_sim),
            mesh=mesh,
            in_specs=(spec, spec, kernel_spec),
            out_specs=(spec, spec),
            # a Pallas kernel's body carries no varying-axes types; the
            # per-device force is purely local, so skip that check for it
            check_vma=not (
                cfg.force_model == "all_pairs"
                and all_pairs_impl != dispatch.XLA
            ),
        )

    # The kernel slab must ride as a jit ARGUMENT, not a closure constant:
    # on a multi-process (pod) mesh it spans non-addressable devices and
    # closing over it is illegal (caught by the 2-process bootstrap test).
    def _stepped(state: ParticleState, kernel, num_sim: Optional[int]):
        pos, vel = make(num_sim)(state.position, state.velocity, kernel)
        return ParticleState(pos, vel)

    if donate:
        jitted = jax.jit(_stepped, static_argnums=(2,), donate_argnums=(0,))
    else:
        jitted = jax.jit(_stepped, static_argnums=(2,))

    def step(state: ParticleState, num_sim: Optional[int] = None) -> ParticleState:
        return jitted(state, kernel_arg, num_sim)

    return step


def gather_positions(state: ParticleState, device: jax.Device) -> jax.Array:
    """All shards -> one device (the render feed / copy-queue analog).

    On a multi-process run the state spans non-addressable devices;
    the feed then goes through a cross-host allgather first (every process
    pays the inter-host gather; only the primary renders — `bootstrap.is_primary`).
    """
    pos = state.position
    if not pos.is_fully_addressable:
        from jax.experimental import multihost_utils

        pos = multihost_utils.process_allgather(pos, tiled=True)
    return jax.device_put(pos, device)
