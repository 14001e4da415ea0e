"""Block-sparse exact near field: the tree-structured P³M near mode.

The static-K cell-list sweep (`ops/p3m.py:near_field_correction`) pads
EVERY cell to one capacity, so a scene with extreme density contrast (the
demo's two-cluster shell init packs thousands of particles into single
near cells — 97% overflow at 65K with any practical K) either loses the
near correction exactly where it matters or pays gn³·27·K² padded work.
This module is the hierarchical fix (VERDICT r2 #2), built from sorts
and gathers, with no scatters and no data-dependent shapes:

1. ONE Morton sort of the particles. Blocks of B consecutive
   Morton-sorted particles are compact, octree-aligned spatial nodes —
   the "tree" is implicit in the code order.
2. Per-block cell-space AABBs via masked segment min/max (node bounds).
3. The dual-tree walk, flattened: an [NB, NB] bbox-adjacency test, then
   ONE stable sort compacts the true entries into an i-major block-pair
   list under a static budget (dropped pairs are counted, never silent).
4. Direct interactions: a chunked B×B pairwise sweep over the listed
   pairs (sources on the minor axis — the `ops/p3m.py`
   layout lesson), accumulated per target block by a sorted segment sum
   and un-sorted back to particle order with one payload sort.

Work scales with the scene's ACTUAL near-pair count — dense cores simply
contribute more block pairs — never with a global max cell capacity.

Pair-set contract: every pair with |cell Δ|∞ ≤ 1 (the 27-neighborhood of
the slot sweep) is included; bbox adjacency may ADD farther pairs whose
short-range factor has already decayed to ≤1.4e-4 of exact, so the
result is equal to or strictly closer to the exact force than the slot
sweep on any scene (`tests/test_treeforce.py` pins both properties).

Reference lineage: subsumes the exactness of the reference's
bodyBodyInteraction O(N²) sum (`nBodyGravityCS.hlsl:44-57`) at
sub-quadratic cost on ANY particle distribution — the reference's only
exact mode cannot be beaten on generality, so this matches it where the
slot sweep could not (the demo init) while keeping the mesh's O(N) far
field.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from multi_adapter_particles_tpu.ops.p3m import _SIGMA_PER_CUTOFF

# np scalar, NOT jnp: a module-level jnp constant would initialize the
# JAX backend at import time
_PARK = np.float32(1.0e9)

# -- Polynomial short-range factor (no erf/exp in the hot loop) --------------
# s_short(r) = s_exact - g_long needs erf + exp per pair (most of the
# sweep's per-pair ops). The
# combined Ewald numerator G(t) = g_long * r^3 (t = r/sigma) is UNIVERSAL
# and satisfies G(t) = sqrt(2/pi) * Int_0^t s^2 e^(-s^2/2) ds — positive,
# no cancellation — so H(v) = G(t)/t^3 (v = t^2) is smooth on [0, t_c^2]
# and a degree-12 least-squares polynomial (fit in the mapped variable
# x = 2v/VMAX - 1 for conditioning, evaluated by 12-FMA HORNER — measured
# identical accuracy to the 24-FMA Clenshaw form: maxrel 5.1e-6 vs the
# f64 truth at every separation) reproduces the force to ~1e-5 of EXACT.
# Beyond the cutoff the factor is set to 0 — inside the 1.4e-4 truncation
# budget the 27-neighborhood already implies.
_TC = 4.5                      # cutoff in t = r/sigma units (= r_c/sigma)
_VMAX = _TC * _TC
_POLY_DEG = 12


def _fit_h_poly():
    """Host-side degree-12 monomial fit of H(v) on [0, VMAX] (f64),
    in the mapped variable x = 2v/VMAX - 1."""
    import math

    import numpy as np

    v = np.linspace(0.0, _VMAX, 8001)
    t = np.sqrt(v)
    # series for small t (alternating, converges fast for v <= 4):
    #   H(v) = sqrt(2/pi) * sum_n (-v/2)^n / (n! (2n+3))
    hs = np.zeros_like(v)
    term = np.ones_like(v)
    for n in range(0, 40):
        hs += term / (2 * n + 3)
        term = term * (-v / 2) / (n + 1)
    hs *= math.sqrt(2.0 / math.pi)
    # exact formula for large t (no cancellation there)
    erf_v = np.vectorize(math.erf)
    with np.errstate(divide="ignore", invalid="ignore"):
        he = (
            erf_v(t / math.sqrt(2.0))
            - math.sqrt(2.0 / math.pi) * t * np.exp(-v / 2.0)
        ) / np.maximum(t, 1e-30) ** 3
    h = np.where(v <= 4.0, hs, he)
    x = 2.0 * v / _VMAX - 1.0
    import numpy.polynomial.polynomial as _P

    return _P.polyfit(x, h, _POLY_DEG).astype(np.float32)


_H_POLY = tuple(float(c) for c in _fit_h_poly())


def _fit_e_poly():
    """Host-side degree-12 monomial fit of E(v) = erf(t/sqrt(2))/t
    (t = r/sigma, v = t²) on [0, VMAX], mapped x = 2v/VMAX - 1 — the
    long-range pair POTENTIAL numerator (u_long = -E/sigma), companion
    of `_fit_h_poly`'s force numerator."""
    import math

    import numpy as np

    v = np.linspace(0.0, _VMAX, 8001)
    t = np.sqrt(v)
    # series: E(v) = sqrt(2/pi) * sum_n (-v/2)^n / (n! (2n+1))
    es = np.zeros_like(v)
    term = np.ones_like(v)
    for n in range(0, 40):
        es += term / (2 * n + 1)
        term = term * (-v / 2) / (n + 1)
    es *= math.sqrt(2.0 / math.pi)
    erf_v = np.vectorize(math.erf)
    with np.errstate(divide="ignore", invalid="ignore"):
        ee = erf_v(t / math.sqrt(2.0)) / np.maximum(t, 1e-30)
    e = np.where(v <= 4.0, es, ee)
    x = 2.0 * v / _VMAX - 1.0
    import numpy.polynomial.polynomial as _P

    return _P.polyfit(x, e, _POLY_DEG).astype(np.float32)


_E_POLY = tuple(float(c) for c in _fit_e_poly())


def short_potential_cheb(d2, eps2, sigma):
    """Polynomial short-range pair POTENTIAL u_short(r) = u_exact - u_long:

        u_exact = -(d² + eps²)^(-1/2)      (softened Plummer)
        u_long  = -erf(r/(sqrt(2)σ)) / r   (Gaussian-smoothed source)

    the potential whose gradient is `short_factor_cheb`'s force
    (du/dr = r * s_short). Same construction: the erf numerator is
    evaluated as a degree-12 Horner polynomial in v = (r/σ)² (finite at
    r = 0: E(0) = sqrt(2/π)), exactly 0 beyond the cutoff (the truncated
    tail there is erfc(4.5/√2)/r ≈ 7e-6/r). Only rsqrt and FMAs.

    NOTE the self-pair: at d2 == 0 this returns sqrt(2/π)/σ - 1/eps
    (NOT zero, unlike the force where r_vec = 0 kills it) — callers must
    subtract that constant once per live particle."""
    u_exact = -jax.lax.rsqrt(d2 + jnp.float32(eps2))
    v = d2 * jnp.float32(1.0 / (sigma * sigma))
    x = jnp.clip(v * jnp.float32(2.0 / _VMAX) - 1.0, -1.0, 1.0)
    e = jnp.full_like(x, jnp.float32(_E_POLY[-1]))
    for c in _E_POLY[-2::-1]:
        e = e * x + jnp.float32(c)
    u = u_exact + e * jnp.float32(1.0 / sigma)
    return jnp.where(v <= jnp.float32(_VMAX), u, 0.0)


def short_potential_self(eps2: float, sigma: float) -> float:
    """u_short(0) — the self-pair constant every live particle picks up
    exactly once in a potential sweep (its own block pairs with itself).
    Evaluated through the SAME f32 Horner polynomial as the sweep so the
    subtraction cancels the self-term exactly (the analytic sqrt(2/π)
    differs from the fit by ~5e-6, which would otherwise accumulate
    N-fold in the total)."""
    e = np.float32(_E_POLY[-1])
    for c in _E_POLY[-2::-1]:
        e = e * np.float32(-1.0) + np.float32(c)     # x(v=0) = -1
    u_exact0 = -np.float32(1.0) / np.float32(np.sqrt(np.float32(eps2)))
    return float(u_exact0 + e * np.float32(1.0 / sigma))


def short_factor_cheb(d2, eps2, sigma):
    """Polynomial s_short: bit-compatible SEMANTICS with p3m._short_factor
    to ~1e-5 of the exact force inside the cutoff, exactly 0 beyond it.
    Only rsqrt and FMAs: ~33 ops/pair vs the erf form's ~55
    (name kept from the Chebyshev-basis original — same fit, now evaluated
    by Horner at half the FMAs)."""
    inv = jax.lax.rsqrt(d2 + jnp.float32(eps2))
    s_exact = inv * inv * inv
    v = d2 * jnp.float32(1.0 / (sigma * sigma))
    x = jnp.clip(v * jnp.float32(2.0 / _VMAX) - 1.0, -1.0, 1.0)
    h = jnp.full_like(x, jnp.float32(_H_POLY[-1]))
    for c in _H_POLY[-2::-1]:
        h = h * x + jnp.float32(c)
    s = s_exact - h * jnp.float32(1.0 / sigma**3)
    return jnp.where(v <= jnp.float32(_VMAX), s, 0.0)


def _morton(ib, bits: int):
    """[3, N] int cell coords in [0, 2^bits) -> interleaved Morton code.

    3*bits <= 30 keeps the code (plus the sentinel above it) in int32."""
    code = jnp.zeros_like(ib[0])
    for b in range(bits):
        for c in range(3):
            code = code | (((ib[c] >> b) & 1) << (3 * b + c))
    return code


def default_pair_budget(num_blocks: int) -> int:
    """Static block-pair budget: generous for uniform scenes (a block has
    ~27-60 bbox neighbors), with headroom for clustered ones; always at
    least the full matrix for tiny inputs."""
    return int(min(num_blocks * num_blocks, max(4096, 64 * num_blocks)))


def default_block(n: int) -> int:
    """Block size keeping the [NB, NB] adjacency matrix (and its
    compaction sort) bounded: NB <= ~2048, so the dual-tree walk stays a
    few-ms side cost from 64K to multi-million particles."""
    b = 256
    while -(-n // b) > 2048:
        b *= 2
    return b


def near_field_tree(
    position: jax.Array,   # [4, N]
    box: float,
    g_const: float,
    eps2: float,
    r_c: float,
    near_grid: int,
    block: int | None = None,
    pair_budget: int | None = None,
    pair_chunk: int | None = None,
    block_owner_fn=None,
    with_potential: bool = False,
    potential_only: bool = False,
    half_pairs: bool = False,
    total_only: bool = False,
):
    """Short-range pairwise correction -> (accel [3, N], dropped_pairs).

    Same force split as `p3m.near_field_correction` (accel = g_const *
    s_short(r) * r_vec summed over near pairs); `near_grid` cells must be
    >= r_c wide so bbox adjacency covers the cutoff. `dropped_pairs`
    counts block pairs beyond `pair_budget` (0 = nothing truncated).
    `block` None = adaptive (NB capped ~2048); `pair_chunk` None scales
    inversely with block² so a sweep chunk stays ~100 MB.
    `block_owner_fn` (mesh runs): callable mapping target block ids
    [P] int32 -> bool "this device owns these targets"; non-owned pairs
    are skipped, so the per-device result is a PARTIAL near field —
    psum it over the mesh (each target block is owned exactly once).
    dropped_pairs stays a GLOBAL count, identical on every device.
    `with_potential` (diagnostics): also return the per-particle
    short-range pair potential u_i = g * sum_j u_short(r_ij) [N] (self
    term removed, out-of-box particles 0; owner-masked like the force,
    so psum composes) -> (accel, u, dropped_pairs). The force-only
    trace is unchanged — the extra pair ops exist only in this variant.
    `potential_only` (requires `with_potential`): skip the force channels
    entirely -> (u, dropped_pairs) — ~2x fewer pair ops; the diagnostics
    gauge uses it when the run's own accel is supplied for the half-kick.
    Same pair list and accumulation order as the fused variant; the
    result matches it to fusion-level rounding (~1 ULP — dropping the
    force channels changes one contraction decision).
    `half_pairs` (requires `potential_only`): Newton-3rd halved pair
    enumeration — the potential is symmetric (u_ij = u_ji), and the
    gauge only consumes the TOTAL 0.5*sum(u), so each unordered block
    pair is listed once (j >= i at sweep granularity; diagonal pairs
    weighted 1/2 in the sweep) for ~2x fewer pair interactions. The
    returned u is rescaled by 2 so `0.5*sum(u)` still equals the total;
    PER-PARTICLE entries are no longer physical (cross-block
    contributions land only on the lower block's side) and the total
    matches the directed enumeration to f32 accumulation-order rounding,
    not bitwise. `pair_budget` keeps its probed full-directed-count
    semantics; the halved requirement (F + diag)/2 is derived
    internally, and `dropped_pairs` is reported in full-directed units
    as well.
    `total_only` (requires `potential_only`): return the SCALAR sum of
    the per-particle potentials -> (u_total, dropped_pairs), skipping
    the un-sort payload sort (the gauge consumes only the total; the
    gated block-order sum equals the particle-order sum up to f32
    reassociation). Owner-masked mesh partials still psum-compose.
    """
    if potential_only and not with_potential:
        raise ValueError("potential_only requires with_potential=True")
    if half_pairs and not potential_only:
        raise ValueError("half_pairs requires potential_only=True")
    if total_only and not potential_only:
        raise ValueError("total_only requires potential_only=True")
    n = position.shape[1]
    if block is None:
        block = default_block(n)
    if pair_chunk is None:
        pair_chunk = max(8, 64 * (256 * 256) // (block * block))
    gn = near_grid
    hn = box / gn
    sigma = r_c * _SIGMA_PER_CUTOFF
    bits = max((gn - 1).bit_length(), 1)
    if 3 * bits + 1 > 31:
        raise ValueError(f"near grid {gn} overflows the int32 Morton code")

    u = position[:3] / jnp.float32(hn) + jnp.float32(gn / 2)
    ib = jnp.floor(u).astype(jnp.int32)
    inbox = jnp.all((ib >= 0) & (ib <= gn - 1), axis=0)
    code = _morton(jnp.clip(ib, 0, gn - 1), bits)
    sentinel = jnp.int32(1 << (3 * bits))
    code = jnp.where(inbox, code, sentinel)  # out-of-box: no near force
    pid = jnp.arange(n, dtype=jnp.int32)
    scode, sx, sy, sz, spid = jax.lax.sort(
        (code, position[0], position[1], position[2], pid),
        dimension=0, num_keys=1, is_stable=False,
    )

    nb = -(-n // block)
    npad = nb * block - n
    if npad:
        scode = jnp.concatenate(
            [scode, jnp.full((npad,), sentinel, jnp.int32)]
        )
        sx = jnp.concatenate([sx, jnp.full((npad,), _PARK)])
        sy = jnp.concatenate([sy, jnp.full((npad,), _PARK)])
        sz = jnp.concatenate([sz, jnp.full((npad,), _PARK)])
        spid = jnp.concatenate(
            [spid, jnp.arange(n, n + npad, dtype=jnp.int32)]
        )

    # Park out-of-box particles (sentinel code): the no-near-force contract
    # of the slot sweep — they must neither feel nor exert short-range
    # force even when they share a boundary block with live particles.
    live_flat = scode < sentinel
    sx = jnp.where(live_flat, sx, _PARK)
    sy = jnp.where(live_flat, sy, _PARK)
    sz = jnp.where(live_flat, sz, _PARK)

    # -- node AABBs (float coords, live-masked) -------------------------------
    live = live_flat.reshape(nb, block)
    any_live = jnp.any(live, axis=1)
    fmin, fmax = [], []
    for s in (sx, sy, sz):
        sb = s.reshape(nb, block)
        fmin.append(jnp.min(jnp.where(live, sb, jnp.float32(4e9)), axis=1))
        fmax.append(jnp.max(jnp.where(live, sb, jnp.float32(-4e9)), axis=1))

    # -- dual-tree walk, flattened: AABB distance -> compacted pair list ----
    # The short-range factor is EXACTLY zero at separations > r_c
    # (`short_factor_cheb` clamps beyond _TC*sigma = r_c), so pruning
    # block pairs whose AABB min distance exceeds r_c is EXACT — and
    # strictly tighter than cell-granularity 27-adjacency, which keeps
    # diagonal cell neighbors with a real gap > r_c and same-cell pairs
    # of tiny far-apart Morton blocks (clustered scenes).
    m = any_live[:, None] & any_live[None, :]
    gap2 = jnp.zeros((nb, nb), jnp.float32)
    for c in range(3):
        g = jnp.maximum(
            jnp.maximum(
                fmin[c][:, None] - fmax[c][None, :],
                fmin[c][None, :] - fmax[c][:, None],
            ),
            0.0,
        )
        gap2 = gap2 + g * g
    m = m & (gap2 <= jnp.float32(r_c) * jnp.float32(r_c))

    if half_pairs:
        # keep j >= i: each unordered block pair listed once (adjacency
        # is symmetric); the diagonal survives and is weighted 1/2 where
        # it is swept. The budget below is halved to match.
        bi = jnp.arange(nb, dtype=jnp.int32)
        m = m & (bi[None, :] >= bi[:, None])
    flat = m.reshape(nb * nb)
    total = jnp.sum(flat.astype(jnp.int32))
    p_max = pair_budget or default_pair_budget(nb)
    p_max = int(min(p_max, nb * nb))
    if half_pairs:
        # budgets are probed on the full directed list (host_pair_budget);
        # the halved list holds (F + D)/2 <= (F + nb)/2 live pairs
        # (D = live diagonal pairs)
        p_max = min((p_max + nb) // 2 + 1, nb * nb)
    pc = int(min(pair_chunk, p_max))
    p_max = max(pc, (p_max // pc) * pc)  # pc | p_max and p_max <= nb*nb

    inv = (~flat).astype(jnp.int32)
    idx = jnp.arange(nb * nb, dtype=jnp.int32)
    skey, sidx = jax.lax.sort((inv, idx), dimension=0, num_keys=1,
                              is_stable=True)
    sidx = sidx[:p_max]                       # i-major (stable sort on iota)
    i_idx = sidx // nb
    j_idx = sidx % nb
    live_pair = skey[:p_max] == 0
    if block_owner_fn is not None:
        live_pair = live_pair & block_owner_fn(i_idx)
    valid = live_pair.astype(jnp.float32)
    dropped = jnp.maximum(total - p_max, 0)
    if half_pairs:
        # one listed unordered off-diagonal pair stands for two directed
        # ones: report the shortfall in the same directed units as the
        # budget (an upper bound; the diagonal counts once either way)
        dropped = dropped * 2

    # -- direct interactions over the listed pairs ----------------------------
    # A chunked scan over the pair list: each chunk gathers its [pc, B]
    # target and source rows, builds the [pc, B, B] pair planes (sources
    # on the minor axis) and segment-sums them into the target blocks.
    bx = sx.reshape(nb, block)
    by = sy.reshape(nb, block)
    bz = sz.reshape(nb, block)
    n_chunks = p_max // pc
    if potential_only:
        nch = 1
    else:
        nch = 4 if with_potential else 3
    if half_pairs:
        # diagonal block pairs keep both in-block orderings (plus the
        # self pairs) in their [B, B] plane — weight them 1/2
        valid = valid * jnp.where(
            j_idx == i_idx, jnp.float32(0.5), jnp.float32(1.0)
        )

    def chunk_body(args):
        ii, jj, vv = args                     # each [pc]
        xi, yi, zi = bx[ii], by[ii], bz[ii]   # [pc, B] wide-row gathers
        xj, yj, zj = bx[jj], by[jj], bz[jj]
        dxv = xj[:, None, :] - xi[:, :, None]  # [pc, B, B] src on lanes
        dyv = yj[:, None, :] - yi[:, :, None]
        dzv = zj[:, None, :] - zi[:, :, None]
        d2 = dxv * dxv + dyv * dyv + dzv * dzv
        parts = []
        if not potential_only:
            # Chebyshev factor: ~2x fewer ops than the erf form, 5.5e-6
            # of exact everywhere (the f32 erf form itself loses 45% at
            # r<0.01 to cancellation — see short_factor_cheb)
            s = short_factor_cheb(d2, eps2, sigma) * vv[:, None, None]
            parts = [
                jnp.sum(s * dxv, axis=-1),
                jnp.sum(s * dyv, axis=-1),
                jnp.sum(s * dzv, axis=-1),
            ]
        if with_potential:
            u = short_potential_cheb(d2, eps2, sigma)
            parts.append(jnp.sum(u * vv[:, None, None], axis=-1))
        return jnp.stack(parts, axis=-1)      # [pc, B, nch]

    # scan accumulates chunk results straight into the per-target
    # buffer — the stacked [P, B, 3] of a lax.map would be gigabytes
    # at multi-million N (and pads its trailing 3 to a full lane tile)
    def chunk_step(acc, args):
        ii = args[0]
        f = chunk_body(args).reshape(pc, block * nch)
        return (
            acc
            + jax.ops.segment_sum(
                f, ii, num_segments=nb, indices_are_sorted=True
            ),
            None,
        )

    # seed the carry from varying data (0*sx[0]) so its manual-axes
    # type matches the body output under shard_map (scan rejects an
    # unvarying init against a mesh-varying carry)
    acc_b, _ = jax.lax.scan(
        chunk_step,
        jnp.zeros((nb, block * nch), jnp.float32) + 0.0 * sx[0],
        (
            i_idx.reshape(n_chunks, pc),
            j_idx.reshape(n_chunks, pc),
            valid.reshape(n_chunks, pc),
        ),
    )
    acc_b = acc_b.reshape(nb * block, nch)
    if potential_only:
        acc_u = acc_b[:, 0]
        acc_x = acc_y = acc_z = None
    else:
        acc_x, acc_y, acc_z = acc_b[:, 0], acc_b[:, 1], acc_b[:, 2]
        acc_u = acc_b[:, 3] if with_potential else None

    scale = jnp.float32(g_const)
    if not with_potential:
        # -- un-sort to particle order (payload sort, not a scatter) ---------
        _, fx, fy, fz = jax.lax.sort(
            (spid, acc_x, acc_y, acc_z),
            dimension=0, num_keys=1, is_stable=False,
        )
        return jnp.stack([fx[:n], fy[:n], fz[:n]]) * scale, dropped

    # Potential channel: unlike the force (where the self/parked pairs
    # contribute r_vec = 0), u_short(0) is a nonzero constant — every
    # live particle picked it up exactly once (its own block pairs with
    # itself once, in every sweep path), and co-parked particles picked
    # it up per parked neighbor. Subtract the self constant from live
    # (owner-masked) entries and zero everything else, in SORTED order
    # where the live/owner masks are natural.
    gate = live_flat
    if block_owner_fn is not None:
        owner_b = block_owner_fn(jnp.arange(nb, dtype=jnp.int32))
        gate = gate & jnp.repeat(owner_b, block)
    u_self = jnp.float32(short_potential_self(float(eps2), float(sigma)))
    if half_pairs:
        # the halved sweep weights the diagonal block pair 1/2, so each
        # live particle picked up exactly half the self constant
        u_self = u_self * jnp.float32(0.5)
    acc_u = jnp.where(gate, acc_u - u_self, 0.0)
    if potential_only:
        # half mode rescales by 2 so the caller's 0.5*sum(u) contract
        # holds unchanged (each unordered pair was counted once, not
        # twice); per-particle entries are sum-only meaningful there
        u_scale = scale * jnp.float32(2.0) if half_pairs else scale
        if total_only:
            # gated entries are already 0 for parked/non-owned rows, so
            # the block-order sum needs no un-sort
            return jnp.sum(acc_u) * u_scale, dropped
        _, fu = jax.lax.sort(
            (spid, acc_u), dimension=0, num_keys=1, is_stable=False,
        )
        return fu[:n] * u_scale, dropped
    _, fx, fy, fz, fu = jax.lax.sort(
        (spid, acc_x, acc_y, acc_z, acc_u),
        dimension=0, num_keys=1, is_stable=False,
    )
    return jnp.stack([fx[:n], fy[:n], fz[:n]]) * scale, fu[:n] * scale, dropped


# budget headroom over the probed initial-state counts: scenes evolve,
# and a breached budget only costs counted (never silent) dropped pairs
PAIR_HEADROOM = 1.25


def host_pair_budget(
    position,              # array-like [4, N] (host or device)
    box: float,
    r_c: float,
    near_grid: int,
    block: int | None = None,
    headroom: float = PAIR_HEADROOM,
) -> int:
    """NumPy replica of the block-pair count — cheap enough to run once
    at startup so the CLI can size `pair_budget` from the ACTUAL scene
    instead of the density-free default (the demo shell at G=64 needs
    ~210 pairs/block where the default budgets 64; a truncated budget
    silently costs accuracy, counted in `dropped_pairs`)."""
    count, _ = host_tree_counts(position, box, r_c, near_grid, block)
    return int(count * headroom) + 1


def host_tree_counts(
    position,
    box: float,
    r_c: float,
    near_grid: int,
    block: int | None = None,
):
    """One Morton sort -> (block_pair_count, block).

    The shared probe behind `host_pair_budget`, `auto_grid` and the
    CLI's budget sizing — the ONE host-side copy of the device walk's
    pruning rule (Morton interleave, live-masked float AABBs, banded
    gap² <= r_c² test); keep it bit-faithful to `near_field_tree`.
    `block` None = the device default for N."""
    import numpy as np

    pos = np.asarray(position)
    n = pos.shape[1]
    if block is None:
        block = default_block(n)

    gn = near_grid
    hn = box / gn
    p3 = pos[:3]
    ib = np.floor(p3 / hn + gn / 2).astype(np.int64)
    inbox = ((ib >= 0) & (ib <= gn - 1)).all(axis=0)
    bits = max(int(gn - 1).bit_length(), 1)
    ibc = np.clip(ib, 0, gn - 1)
    code = np.zeros(n, np.int64)
    for b in range(bits):
        for c in range(3):
            code |= ((ibc[c] >> b) & 1) << (3 * b + c)
    code[~inbox] = 1 << (3 * bits)
    order = np.argsort(code, kind="stable")
    spos = p3[:, order].astype(np.float32)
    live = inbox[order]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        spos = np.concatenate([spos, np.zeros((3, pad), np.float32)], axis=1)
        live = np.concatenate([live, np.zeros(pad, bool)])
    bpos = spos.reshape(3, nb, block)
    blive = live.reshape(nb, block)
    fmin = np.where(blive[None], bpos, 4e9).min(axis=2)    # [3, nb]
    fmax = np.where(blive[None], bpos, -4e9).max(axis=2)
    alive = blive.any(axis=1)
    rc2 = np.float32(r_c) ** 2

    count = 0
    band = 4096
    for lo in range(0, nb, band):
        hi = min(lo + band, nb)
        m = alive[lo:hi, None] & alive[None, :]
        gap2 = np.zeros((hi - lo, nb), np.float32)
        for c in range(3):
            g = np.maximum(
                np.maximum(
                    fmin[c][lo:hi, None] - fmax[c][None, :],
                    fmin[c][None, :] - fmax[c][lo:hi, None],
                ),
                0.0,
            )
            gap2 += g * g
        count += int((m & (gap2 <= rc2)).sum())
    return count, block


# Auto-grid cost model, least-squares fitted to measured grid sweeps on
# the two-cluster demo init at 262K and 1M (ROADMAP: "the grid optimum
# shifts with N"):
#   accel_ms ~= _COST_PER_PAIR * pair_interactions
#             + _COST_FAR * G^3 * log2(G)          (FFT far field + grids)
#             + _COST_PER_N * N                    (sort/adjacency/gathers)
# Only the RANKING matters, and it is driven by scene pair count vs the
# G^3 far field. The coefficients predate the GPU and have not been
# re-fitted on it (ROADMAP S4). The ladder keeps to 2^a*3^b sizes, which
# the FFT handles best; the band tie-break below prefers the larger grid.
_COST_PER_PAIR = 1.374e-8
_COST_FAR = 3.911e-6
_COST_PER_N = 4.316e-5
_COST_BAND = 1.2

AUTO_GRID_LADDER = (64, 96, 128, 192, 256, 384, 512)

# Device-memory feasibility of the long-range solve: its binding
# allocation is the DOUBLED-GRID FFT working set, ~10 simultaneously
# live (2G)^3-float buffers (pruned-rfft intermediates incl. remat
# copies), i.e. ~364 B per G-cell in the compiled program's temp
# allocation. A grid is admitted while that fits in 7/8 of the device's
# memory limit (the rest holds the particle state and the frame).
_SOLVE_BYTES_PER_CELL = 364


def solve_budget_bytes(device=None) -> int:
    """Device memory the long-range solve may take on `device`."""
    from multi_adapter_particles_tpu.ops.dispatch import memory_limit_bytes

    return memory_limit_bytes(device) * 7 // 8


def feasible_grid(g: int, budget: int | None = None) -> bool:
    """Whether grid g's long-range FFT solve fits the memory budget
    (default: `solve_budget_bytes()` of the default device)."""
    if budget is None:
        budget = solve_budget_bytes()
    return g ** 3 * _SOLVE_BYTES_PER_CELL <= budget


def counts_cache_key(gn: int, r_c: float):
    """Canonical `counts_cache` key for one (near-grid, cutoff) probe.
    The float goes through one fixed format so lookups are exact across
    processes (utils/probecache.py persists these keys as JSON)."""
    return (int(gn), f"{float(r_c):.9g}")


def auto_grid(
    position,
    box: float,
    cutoff_cells: float,
    candidates=AUTO_GRID_LADDER,
    counts_cache: dict | None = None,
    num_particles: int | None = None,
) -> int:
    """Pick the mesh size minimizing the modeled tree-P3M accel time.

    Probes the ACTUAL scene: per candidate G the host block-pair count
    (the same exact pruning rule the device walk uses) prices the near
    sweep, against the G^3 log G far field. The optimum shifts with the
    scene and N — measured 128 @262K but 192 @1M on the demo init — so a
    fixed default is wrong somewhere; this replaces it with the measured
    cost model above.

    Tie-break: among candidates within _COST_BAND of the minimum modeled
    cost, take the LARGEST grid. Within model noise the larger grid is
    the safer bet — its cost is dominated by the exactly-known far-field
    term, while the pair term can only grow as the scene clusters over
    time; the rule also matches the measured 262K call (96 vs 128 model
    costs within 8%, 128 measured 14% faster).

    `counts_cache`: optional dict of `counts_cache_key(gn, r_c)` ->
    `host_tree_counts` pair — probes hit the cache and misses fill it
    (a 4M probe is ~15-25 s; utils/probecache.py persists the dict
    across launches). `position` may then be a ZERO-ARG CALLABLE,
    materialized only on a cache miss (skips the 4M device init + host
    copy on a warm cache) — pass `num_particles` alongside so the
    ladder trimming needn't touch it either.
    """
    import numpy as np

    if callable(position):
        pos_fn, _pos = position, None

        def get_pos():
            nonlocal _pos
            if _pos is None:
                _pos = np.asarray(pos_fn())
            return _pos
    else:
        def get_pos():
            return position

    n = num_particles
    if n is None:
        n = np.asarray(get_pos()).shape[1]
    is_default = candidates is AUTO_GRID_LADDER
    budget = solve_budget_bytes()
    candidates = tuple(g for g in candidates if feasible_grid(g, budget))
    if not candidates:
        raise ValueError(
            "no auto_grid candidate fits the device-memory solve budget "
            f"({budget} B); largest feasible grid is "
            f"{int((budget / _SOLVE_BYTES_PER_CELL) ** (1 / 3))}"
        )
    if is_default:
        # probe cost is ~15-25 s per candidate at 4M (a fresh Morton
        # sort + banded AABB count each); small grids are strictly
        # dominated at scale (measured/modeled: G<=128 @4M >= 3x the
        # optimum, @16.8M >= 10x) — trim them instead of pricing them
        if n > 8_000_000:
            candidates = tuple(g for g in candidates if g >= 256)
        elif n > 2_000_000:
            candidates = tuple(g for g in candidates if g >= 192)
    costs = {}
    for g in candidates:
        r_c = cutoff_cells * box / g
        gn = max(int(box // r_c), 1)
        ck = counts_cache_key(gn, r_c)
        if counts_cache is not None and ck in counts_cache:
            count, block = counts_cache[ck]
        else:
            count, block = host_tree_counts(get_pos(), box, r_c, gn)
            if counts_cache is not None:
                counts_cache[ck] = (count, block)
        pairs = float(count) * block * block
        costs[g] = (
            _COST_PER_PAIR * pairs
            + _COST_FAR * g ** 3 * np.log2(g)
            + _COST_PER_N * n
        )
    cmin = min(costs.values())
    return int(max(g for g, c in costs.items() if c <= _COST_BAND * cmin))
