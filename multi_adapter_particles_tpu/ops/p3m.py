"""P³M (particle-particle particle-mesh): exact-at-all-separations gravity.

Extends the PM force model (`ops/pm.py`) the Hockney & Eastwood way: an
Ewald split of the softened pair factor s(r) = (r²+eps²)^(-3/2),

    s_long  = g_l(r; σ_eff)   the field of a Gaussian-smoothed source,
                              solved on the mesh
    s_short = s - s_long      summed pairwise, decayed to ≤1.4e-4 of s
                              by r_c = 4.5 σ_eff

with σ_eff tied to the mesh cell (default 1.5h). The mesh convolves the
ANALYTIC long-range acceleration kernels (no finite-difference
truncation) tabulated at σ_tab = sqrt(σ_eff² - h²/3), so the variance
the CIC deposit+interp windows add composes to exactly σ_eff — the
delivered mesh pair response IS g_l(σ_eff), with no spectral
deconvolution and hence no amplified aliasing noise. The short-range
remainder is summed over the 27-cell neighborhood of a binning grid
whose cell size >= r_c. The model therefore converges to the exact
all-pairs force at EVERY separation instead of only beyond ~2 cells;
`tests/test_p3m.py` pins the accuracy vs `integrator.all_pairs_accel`.

This force model has no counterpart in the reference (which offers the
O(N) central well of `particleCS.hlsl` and the O(N²) exact sum of
`nBodyGravityCS.hlsl:44-57`); it uses the same pair law and softening as
the latter so it slots in as `force_model="p3m"`.

Construction with the same toolbox as `ops/pm.py` (sorts, not
scatters; shifted slices, not neighbor gathers):
- Binning: one sort by near-cell id carrying (x, y, z, pid); per-cell
  slot table [Gn³, K] built from merge-by-sort segment bounds. K
  (`capacity`) is static; overflowing particles simply receive no
  short-range correction (they keep the smooth mesh force) and the
  overflow count is returned as a diagnostic.
- Pair sweep: the 27 neighbor cells are SHIFTED SLICES of the padded
  [Gn, Gn, Gn, K, 4] slot tensor — zero gathers — and empty slots are
  parked at 1e9 where the correction formula underflows to exactly 0
  (exp(-1e18) = 0), so the inner K x K x 27 sweep needs no masks at all.
- Un-binning: slot forces return to particle order via one payload sort
  on the particle id (the inverse permutation is a sort, not a scatter).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu.ops import pm


_SIGMA_PER_CUTOFF = 1.0 / 4.5   # sigma_eff = r_c/4.5: tail there ≈ 1.4e-4
_CIC2_VARIANCE_CELLS = 1.0 / 3.0  # variance added by deposit+interp CIC, h²

# σ_tab² = σ_eff² - h²/3 must stay positive: the CIC windows ALONE may not
# contribute more variance than the whole effective Gaussian. In cutoff
# units that is (cutoff_cells/4.5)² > 1/3.
MIN_CUTOFF_CELLS = _CIC2_VARIANCE_CELLS**0.5 / _SIGMA_PER_CUTOFF  # ≈ 2.598


def validate_cutoff_cells(cutoff_cells: float) -> None:
    """Reject cutoffs whose σ_tab² = σ_eff² - h²/3 would go non-positive
    (a negative base under **0.5 produced an opaque complex-dtype
    TypeError deep inside jnp before this guard)."""
    if (cutoff_cells * _SIGMA_PER_CUTOFF) ** 2 <= _CIC2_VARIANCE_CELLS:
        raise ValueError(
            f"p3m cutoff_cells={cutoff_cells} is below the minimum usable "
            f"cutoff (~{MIN_CUTOFF_CELLS:.3f} cells): the CIC deposit+interp "
            "variance h²/3 would exceed σ_eff² and the tabulated kernel "
            "width σ_tab would be imaginary. Raise -p3mcutoff."
        )


def _g_long(d2, sigma):
    """Ewald long-range pair factor for a Gaussian-smoothed unit source:

        g_l(r) = [erf(r/√2σ) - √(2/π)(r/σ) e^(-r²/2σ²)] / r³

    (accel = g_l * r_vec). Analytic C^∞; ~1/r³ beyond ~4σ; finite at 0.
    The r³ division is guarded so r = 0 (self-pairs, parked-slot pairs)
    evaluates to 0 — those contributions multiply r_vec = 0 anyway."""
    r = jnp.sqrt(d2)
    u = r * jnp.float32(1.0 / (jnp.sqrt(2.0) * sigma))
    num = jax.scipy.special.erf(u) - jnp.float32(
        jnp.sqrt(2.0 / jnp.pi) / sigma
    ) * r * jnp.exp(d2 * jnp.float32(-0.5 / sigma**2))
    return num / jnp.maximum(d2 * r, jnp.float32(1e-30))


def _short_factor(d2, eps2, sigma_eff):
    """s_short(r): accel = g * s_short * r_vec for the pair correction.

    Hockney & Eastwood reference-force split with the MESH RESPONSE as the
    long part: s_short = s_exact - g_l(r; σ_eff), where

        s_exact = (d²+eps²)^(-3/2)
        g_l     = the Ewald factor of a Gaussian source of width σ_eff

    and σ_eff² = σ_tab² + h²/3: the mesh tabulates a σ_tab Gaussian-source
    kernel and the CIC deposit+interp windows add h²/3 of variance, so
    what the mesh DELIVERS between two particles is g_l(σ_eff) — which is
    exactly what this subtracts. Two alternatives were measured and
    rejected on the way here (two-body sweeps, G=32 box=2048):
    - C² polynomial switch + spectral CIC deconvolution: the kernel is
      only C¹, deconvolution makes the mesh response RING, ±5-22%;
    - Gaussian switch on the SOFTENED factor + full sinc⁻⁴ deconvolution:
      bias gone but deconvolution amplifies aliasing noise to 11-26% sd
      at sub-2-cell separations (vs ≤4.5% undeconvolved).
    Matching variances instead needs NO deconvolution: low noise and no
    smearing bias. Softening lives only in s_exact (it is ≤0.1% of the
    force beyond 2 cells, where the mesh share matters).

    Beyond r_c = 4.5 σ_eff the factor has decayed to ≤1.4e-4 of exact
    (the truncation the 27-cell neighborhood implies); parked 1e9 slots
    evaluate to ~1e-27 and underflow harmlessly."""
    inv = jax.lax.rsqrt(d2 + jnp.float32(eps2))
    s_exact = inv * inv * inv
    return s_exact - _g_long(d2, sigma_eff)


def _long_grad_kernels_rfft(grid: int, box: float, r_c: float):
    """rffts of the ANALYTIC acceleration kernels
    K_axis(v) = -g_l(|v|; σ_tab) v_axis on the doubled grid (min-image
    offsets). Pure function of statics — constant-folded under jit.

    Tabulating the gradient analytically (3 inverse FFT sets instead of 1)
    removes the 2nd-order finite-difference truncation error that caps
    pure PM at ~5%. K(0) = 0: no self-peak.

    σ_tab = sqrt(σ_eff² - h²/3) pre-compensates the variance the CIC
    deposit+interp windows add (h²/6 each), so the DELIVERED mesh pair
    response is g_l(σ_eff) — matching `_short_factor`'s subtraction with
    no spectral deconvolution (see there for the measured failure modes
    of the deconvolving alternatives)."""
    g2 = 2 * grid
    h = box / grid
    sigma_eff = r_c * _SIGMA_PER_CUTOFF
    sigma_tab = float(
        (sigma_eff**2 - _CIC2_VARIANCE_CELLS * h * h) ** 0.5
    )
    m = jnp.arange(g2)
    off = (((m + grid) % g2) - grid).astype(jnp.float32) * h
    rz = off[:, None, None]
    ry = off[None, :, None]
    rx = off[None, None, :]
    d2 = rx * rx + ry * ry + rz * rz
    s_long = _g_long(d2, sigma_tab)
    return (
        jnp.fft.rfftn(-s_long * rx),
        jnp.fft.rfftn(-s_long * ry),
        jnp.fft.rfftn(-s_long * rz),
    )


def _long_potential_kernel_rfft(grid: int, box: float, r_c: float):
    """rfft of the ANALYTIC long-range POTENTIAL kernel
    K_phi(v) = -erf(|v|/(√2 σ_tab))/|v| (finite at 0: -√(2/π)/σ_tab) on
    the doubled grid — the potential whose negative gradient is the
    `_long_grad_kernels_rfft` acceleration. Same σ_tab variance
    pre-compensation: the CIC deposit+interp windows add h²/3, so the
    DELIVERED mesh pair potential is -erf(r/(√2 σ_eff))/r, matching
    `treeforce.short_potential_cheb`'s u_long subtraction."""
    g2 = 2 * grid
    h = box / grid
    sigma_eff = r_c * _SIGMA_PER_CUTOFF
    sigma_tab = float(
        (sigma_eff**2 - _CIC2_VARIANCE_CELLS * h * h) ** 0.5
    )
    m = jnp.arange(g2)
    off = (((m + grid) % g2) - grid).astype(jnp.float32) * h
    rz = off[:, None, None]
    ry = off[None, :, None]
    rx = off[None, None, :]
    d2 = rx * rx + ry * ry + rz * rz
    r = jnp.sqrt(d2)
    u = r * jnp.float32(1.0 / (jnp.sqrt(2.0) * sigma_tab))
    limit0 = jnp.float32(-((2.0 / jnp.pi) ** 0.5) / sigma_tab)
    kphi = jnp.where(
        d2 > 0.0,
        -jax.scipy.special.erf(u) / jnp.maximum(r, jnp.float32(1e-30)),
        limit0,
    )
    return jnp.fft.rfftn(kphi)


def _potential_rows_long(rho, grid: int, box: float, g_const: float,
                         r_c: float):
    """Long-range potential solve -> lane-packed scalar corner rows
    (`pm._pack_scalar_corner_rows` form, for `pm._interp_scalar`)."""
    kp = _long_potential_kernel_rfft(grid, box, r_c)
    fr = pm._rfft_pruned(rho, grid)
    phi = pm._irfft_pruned(fr * kp, grid) * jnp.float32(g_const)
    return pm._pack_scalar_corner_rows(phi, grid)


def _accel_rows_long(rho, grid: int, box: float, g_const: float,
                     r_c: float):
    """Long-range field solve -> lane-packed [G³/4, 128] rows (analog of
    `pm._accel_rows` with analytic gradient kernels: one shared forward
    transform, three pruned inverses). Softening is intentionally absent
    here — it lives only in `_short_factor`'s s_exact term (it is ≤0.1%
    of the force beyond 2 cells, where the mesh share matters)."""
    g = grid
    kx, ky, kz = _long_grad_kernels_rfft(g, box, r_c)
    fr = pm._rfft_pruned(rho, g)
    scale = jnp.float32(g_const)
    ax = pm._irfft_pruned(fr * kx, g) * scale
    ay = pm._irfft_pruned(fr * ky, g) * scale
    az = pm._irfft_pruned(fr * kz, g) * scale

    # lane-packed [G³/4, 128] corner rows — see pm._pack_corner_rows
    return pm._pack_corner_rows(ax, ay, az, g)


def _bin_particles(position, gn: int, hn: float, capacity: int):
    """Sort by near-cell, build the [Gn³, K] slot table.

    Returns (slots [ncell, K, 4] with empty slots parked at 1e9,
    scid, spid, bounds, overflow_count)."""
    n = position.shape[1]
    ncell = gn * gn * gn
    u = position[:3] / jnp.float32(hn) + jnp.float32(gn / 2)
    ib = jnp.floor(u).astype(jnp.int32)
    inbox = jnp.all((ib >= 0) & (ib <= gn - 1), axis=0)
    cid = ib[2] * gn * gn + ib[1] * gn + ib[0]
    cid = jnp.where(inbox, cid, ncell)
    pid = jnp.arange(n, dtype=jnp.int32)
    scid, sx, sy, sz, spid = jax.lax.sort(
        (cid, position[0], position[1], position[2], pid),
        dimension=0, num_keys=1, is_stable=False,
    )
    bounds = pm._segment_bounds(scid, ncell)
    counts = bounds[1:] - bounds[:-1]                       # [ncell]
    overflow = jnp.sum(jnp.maximum(counts - capacity, 0))

    # slot index table; out-of-range slots point at the sentinel row n
    k = jnp.arange(capacity, dtype=jnp.int32)[None, :]
    slot_idx = bounds[:-1, None] + k                        # [ncell, K]
    slot_idx = jnp.where(k < counts[:, None], slot_idx, n)
    from multi_adapter_particles_tpu.ops.rowgather import gather_rows

    park = jnp.float32(1.0e9)
    spos4 = jnp.stack(
        [jnp.append(sx, park), jnp.append(sy, park),
         jnp.append(sz, park), jnp.zeros(n + 1, jnp.float32)], axis=1,
    )                                                       # [n+1, 4] rows
    slots = gather_rows(spos4, slot_idx.reshape(-1)).reshape(
        ncell, capacity, 4
    )
    return slots, scid, spid, bounds, overflow


def _near_sweep(slots, gn: int, capacity: int, g_const: float,
                eps2: float, r_c: float):
    """27-offset shifted-slice pair sweep -> slot forces [Gn³, K, 4]
    (x, y, z, 0 — the zero channel makes 16 B rows for the un-binning
    lane-packed gather).

    Layout matters most here: the pair tensors are THREE
    separate [gn, gn, gn, K, K] component arrays with sources on the
    minor (last) axis — a stacked [..., K, K, 3] formulation puts a
    length-3 axis minor, which pads and strides badly. The source-axis
    reduction is a minor-axis sum XLA handles natively."""
    k = capacity
    sigma = r_c * _SIGMA_PER_CUTOFF
    comp = slots.reshape(gn, gn, gn, k, 4)
    own = [comp[..., c][..., :, None] for c in range(3)]    # [g,g,g,K,1]
    pads = []
    for c in range(3):
        p = jnp.full((gn + 2, gn + 2, gn + 2, k), 1.0e9, jnp.float32)
        pads.append(p.at[1:-1, 1:-1, 1:-1].set(comp[..., c]))
    acc = [jnp.zeros((gn, gn, gn, k), jnp.float32) for _ in range(3)]
    for dz in (0, 1, 2):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                nb = [
                    pads[c][dz : dz + gn, dy : dy + gn, dx : dx + gn]
                    for c in range(3)
                ]
                dxv = nb[0][..., None, :] - own[0]          # [g,g,g,K,K]
                dyv = nb[1][..., None, :] - own[1]
                dzv = nb[2][..., None, :] - own[2]
                d2 = dxv * dxv + dyv * dyv + dzv * dzv
                s = _short_factor(d2, eps2, sigma)
                acc[0] = acc[0] + jnp.sum(s * dxv, axis=-1)
                acc[1] = acc[1] + jnp.sum(s * dyv, axis=-1)
                acc[2] = acc[2] + jnp.sum(s * dzv, axis=-1)
    scale = jnp.float32(g_const)
    # 4th zero channel: 16-byte rows pack 32-per-128-lane in the
    # un-binning row gather (ops/rowgather.py)
    acc.append(jnp.zeros_like(acc[0]))
    return jnp.stack(
        [a.reshape(gn * gn * gn, k) * scale for a in acc], axis=-1
    )


def near_field_correction(
    position: jax.Array,   # [4, N]
    box: float,
    g_const: float,
    eps2: float,
    r_c: float,
    near_grid: int,
    capacity: int,
):
    """Short-range pairwise correction -> (accel [3, N], overflow count).

    `near_grid` must satisfy box/near_grid >= r_c so the 27-neighborhood
    covers the cutoff (validated by the caller)."""
    n = position.shape[1]
    gn = near_grid
    hn = box / gn
    ncell = gn * gn * gn
    slots, scid, spid, bounds, overflow = _bin_particles(
        position, gn, hn, capacity
    )
    slot_force = _near_sweep(slots, gn, capacity, g_const, eps2, r_c)

    # map slot forces back to sorted particles: particle i (sorted) sits in
    # slot (scid[i], i - bounds[scid[i]]); k >= capacity means overflow ->
    # zero correction
    from multi_adapter_particles_tpu.ops.rowgather import gather_rows

    live = scid < ncell
    start = bounds[jnp.where(live, scid, ncell)]            # ascending gather
    krank = jnp.arange(n, dtype=jnp.int32) - start
    ok = live & (krank < capacity)
    row = jnp.where(ok, jnp.where(live, scid, 0) * capacity + krank, 0)
    f_sorted = jnp.where(
        ok[:, None],
        gather_rows(slot_force.reshape(ncell * capacity, 4), row)[:, :3],
        0.0,
    )
    _, fx, fy, fz = jax.lax.sort(
        (spid, f_sorted[:, 0], f_sorted[:, 1], f_sorted[:, 2]),
        dimension=0, num_keys=1, is_stable=False,
    )
    return jnp.stack([fx, fy, fz]), overflow


@functools.partial(
    jax.jit,
    static_argnames=(
        "grid", "box", "g_const", "softening_squared", "cutoff_cells",
        "capacity", "near_mode", "pair_budget", "with_potential",
    ),
)
def p3m_accel_with_overflow(
    position: jax.Array,   # [4, N]
    grid: int = 64,
    box: float = 2048.0,
    g_const: float = 1.0,
    softening_squared: float = 25.0,
    cutoff_cells: float = 6.75,
    capacity: int = 64,
    near_mode: str = "slots",
    pair_budget: int | None = None,
    with_potential: bool = False,
):
    """-> (accel [3, N], overflow): mesh long-range + pairwise short-range.

    `near_mode`: "slots" = the static-K 27-cell sweep (fastest on
    uniform-to-moderate scenes; overflow counts particles losing their
    correction); "tree" = the Morton-block dual-tree sweep
    (`ops/treeforce.py` — exact near field on ANY density contrast,
    including the demo's cluster cores; overflow counts dropped block
    pairs, 0 in practice).

    `with_potential` (tree mode only — the diagnostics gauge): also
    return the per-particle softened pair potential
    u_i = g * sum_{j != i} -1/sqrt(r_ij² + eps²), split the same Ewald
    way (mesh erf/r long part + pairwise short remainder, both
    self-term-free) -> (accel [3, N], u [N], overflow). Total potential
    energy = 0.5 * sum(u). Costs one extra scalar field solve + the
    potential channel of the near sweep on top of the force."""
    validate_cutoff_cells(cutoff_cells)
    r_c = cutoff_cells * box / grid
    gn = max(int(box // r_c), 1)          # cell size box/gn >= r_c; at
    # gn <= 2 the 27-neighborhood spans the whole grid, so coverage holds
    # even when r_c > box/3 (a gn floor of 3 would shrink cells BELOW the
    # cutoff and silently miss pairs)
    if with_potential and near_mode != "tree":
        raise ValueError(
            "with_potential requires near_mode='tree' (the slot sweep has "
            "no potential channel)"
        )
    rho = pm.deposit_cic(position, grid, box)
    acc32 = _accel_rows_long(rho, grid, box, g_const, r_c)
    a_far = pm._interp(acc32, position, grid, box)
    if near_mode == "tree":
        from multi_adapter_particles_tpu.ops.treeforce import near_field_tree

        near = near_field_tree(
            position, box, g_const, softening_squared, r_c, gn,
            pair_budget=pair_budget, with_potential=with_potential,
        )
        if with_potential:
            a_near, u_near, overflow = near
            rows_phi = _potential_rows_long(rho, grid, box, g_const, r_c)
            u_long, inside = pm._interp_scalar(rows_phi, position, grid, box)
            # remove the particle's own smoothed blob from the mesh term:
            # the delivered self response is u_long(0; σ_eff) = -√(2/π)/σ_eff
            # per unit coupling (same matched-variance argument as the force)
            sigma_eff = r_c * _SIGMA_PER_CUTOFF
            self_long = jnp.float32(
                g_const * float((2.0 / jnp.pi) ** 0.5) / sigma_eff
            )
            u_long = u_long + jnp.where(inside, self_long, 0.0)
            return a_far + a_near, u_long + u_near, overflow
        a_near, overflow = near
    elif near_mode == "slots":
        a_near, overflow = near_field_correction(
            position, box, g_const, softening_squared, r_c, gn, capacity
        )
    else:
        raise ValueError(f"unknown near_mode {near_mode!r}")
    return a_far + a_near, overflow


def p3m_accel(position, **kw):
    """-> accel [3, N] (overflow diagnostic dropped)."""
    acc, _ = p3m_accel_with_overflow(position, **kw)
    return acc


def p3m_potential_with_overflow(
    position: jax.Array,   # [4, N]
    grid: int = 64,
    box: float = 2048.0,
    g_const: float = 1.0,
    softening_squared: float = 25.0,
    cutoff_cells: float = 6.75,
    pair_budget: int | None = None,
    half_pairs: bool = False,
):
    """-> (u [N], overflow): the potential HALF of
    `p3m_accel_with_overflow(..., with_potential=True)` with none of its
    force work — no gradient field solves, potential-only near sweep
    (~2x fewer pair ops). u matches the fused variant's to fusion-level
    rounding (same scalar mesh solve, same pair list, same accumulation
    order; ~1 ULP).
    The diagnostics gauge uses this when the run's own accel is threaded
    in for the half-kick instead of recomputing a tree force.
    `half_pairs`: Newton-3rd halved near sweep (~2x fewer pair
    interactions again) — 0.5*sum(u) is unchanged to f32
    accumulation-order rounding, but PER-PARTICLE u entries are
    sum-only meaningful (see `treeforce.near_field_tree`)."""
    validate_cutoff_cells(cutoff_cells)
    r_c = cutoff_cells * box / grid
    gn = max(int(box // r_c), 1)
    from multi_adapter_particles_tpu.ops.treeforce import near_field_tree

    rho = pm.deposit_cic(position, grid, box)
    u_near, overflow = near_field_tree(
        position, box, g_const, softening_squared, r_c, gn,
        pair_budget=pair_budget,
        with_potential=True, potential_only=True, half_pairs=half_pairs,
    )
    rows_phi = _potential_rows_long(rho, grid, box, g_const, r_c)
    u_long, inside = pm._interp_scalar(rows_phi, position, grid, box)
    sigma_eff = r_c * _SIGMA_PER_CUTOFF
    self_long = jnp.float32(
        g_const * float((2.0 / jnp.pi) ** 0.5) / sigma_eff
    )
    u_long = u_long + jnp.where(inside, self_long, 0.0)
    return u_long + u_near, overflow


def p3m_potential_total_with_overflow(
    position: jax.Array,   # [4, N]
    grid: int = 64,
    box: float = 2048.0,
    g_const: float = 1.0,
    softening_squared: float = 25.0,
    cutoff_cells: float = 6.75,
    pair_budget: int | None = None,
    half_pairs: bool = True,
):
    """-> (sum_u scalar, overflow): `sum(p3m_potential_with_overflow()[0])`
    without ever materializing per-particle values — the diagnostics
    gauge consumes only the total 0.5*sum(u).

    Long part by the CIC ADJOINT identity: the gather-back weights are
    the deposit weights (both sides run `pm._cic_cells` +
    `pm._corner_weights`, and out-of-box particles are dropped/zeroed
    identically), so

        sum_i phi_gathered(x_i) = sum_c phi(c) * rho(c)
        sum_i inside_i          = sum_c rho(c)

    exactly in exact arithmetic — one elementwise G³ dot against the
    already-deposited rho replaces the G³ corner-row packing
    (`pm._pack_scalar_corner_rows`) AND the N-row trilinear gather-back
    (`pm._interp_scalar`). Near part summed on the sweep's gated
    block-order output (`near_field_tree(total_only=True)`), skipping
    the un-sort payload sort. Matches the per-particle path's total to
    f32 reassociation rounding (pinned in tests/test_p3m.py)."""
    validate_cutoff_cells(cutoff_cells)
    r_c = cutoff_cells * box / grid
    gn = max(int(box // r_c), 1)
    from multi_adapter_particles_tpu.ops.treeforce import near_field_tree

    rho = pm.deposit_cic(position, grid, box)
    u_near_total, overflow = near_field_tree(
        position, box, g_const, softening_squared, r_c, gn,
        pair_budget=pair_budget,
        with_potential=True, potential_only=True, half_pairs=half_pairs,
        total_only=True,
    )
    kp = _long_potential_kernel_rfft(grid, box, r_c)
    phi = pm._irfft_pruned(pm._rfft_pruned(rho, grid) * kp, grid)
    sigma_eff = r_c * _SIGMA_PER_CUTOFF
    self_long = jnp.float32(
        float((2.0 / jnp.pi) ** 0.5) / sigma_eff
    )
    u_long_total = jnp.float32(g_const) * (
        jnp.sum(phi * rho) + self_long * jnp.sum(rho)
    )
    return u_long_total + u_near_total, overflow


def host_overflow_count(
    position,              # array-like [4, N] (host or device)
    grid: int,
    box: float,
    cutoff_cells: float,
    capacity: int,
) -> int:
    """NumPy replica of the binning's overflow diagnostic — cheap enough
    to run once at startup (no trace, no device work) so the app can
    report near-field coverage before committing to a capacity."""
    import numpy as np

    r_c = cutoff_cells * box / grid
    gn = max(int(box // r_c), 1)
    hn = box / gn
    pos = np.asarray(position)[:3]
    ib = np.floor(pos / hn + gn / 2).astype(np.int64)
    inbox = ((ib >= 0) & (ib <= gn - 1)).all(axis=0)
    cid = ib[2] * gn * gn + ib[1] * gn + ib[0]
    counts = np.bincount(cid[inbox], minlength=gn**3)
    return int(np.maximum(counts - capacity, 0).sum())


def make_accel_fn(
    mass: float,
    softening_squared: float = 25.0,
    grid: int = 64,
    box: float = 2048.0,
    cutoff_cells: float = 6.75,
    capacity: int = 64,
    near_mode: str = "slots",
    pair_budget: int | None = None,
):
    """Adapter matching the integrator's accel_fn signature."""
    if near_mode == "auto":
        near_mode = "slots"  # data-free default; app.py probes the initial
        # state with host_overflow_count and picks "tree" when slots overflow

    def accel_fn(position: jax.Array) -> jax.Array:
        return p3m_accel(
            position, grid=grid, box=box, g_const=mass,
            softening_squared=softening_squared,
            cutoff_cells=cutoff_cells, capacity=capacity,
            near_mode=near_mode, pair_budget=pair_budget,
        )

    return accel_fn
