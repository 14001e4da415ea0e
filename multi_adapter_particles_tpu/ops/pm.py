"""Particle-mesh (PM) self-gravity: FFT convolution, isolated boundaries.

A third force model beyond the reference's pair (central well O(N),
all-pairs O(N²)): classic PM a la Hockney & Eastwood — deposit mass on a
grid, convolve with the softened potential kernel via zero-padded FFTs
(free-space, NOT periodic: the demo is an isolated system), take a
central-difference gradient, interpolate forces back. O(N + G³ log G):
multi-million-particle *self*-gravity at interactive rates where the exact
O(N²) sum takes minutes (94 s at 4M).

The potential kernel is the softened pair law, phi(r) = -g (|r|²+eps²)^{-1/2}
with the same mass and softening as the all-pairs model
(`nBodyGravityCS.hlsl:44-57` math), so PM converges to the all-pairs force
for separations ≳ 2 cells; sub-cell structure is smoothed by CIC + the
finite-difference stencil.

Construction with no scatters and no binary searches anywhere;
everything irregular is a sort (whether a plain `.at[].add` scatter
beats it on the GPU is open, ROADMAP S3):
- **Deposit**: ONE sort of base cell ids carrying the three CIC fractions
  (the 8 corner weights are recomputed post-sort — payloads cost
  per-operand). Per-cell boundaries come from a merge-by-sort instead
  of `jnp.searchsorted` with G³ queries (a while loop of random gathers):
  sort `concat(2*cells, 2*keys+1)`, compact the even (query) entries
  with a second keyed sort, and read boundary positions off the result.
  Then one cumsum over the 8 corner-weight channels + ONE row-gather at
  the boundaries gives all 8 shifted histograms (a corner's cell id is
  the base id plus a constant offset, so its histogram is the base
  histogram SHIFTED).
- **Solve**: rfft(counts) x cached kernel rfft -> irfft with both ends of
  every axis pruned (free-space/zero-padded): 2 FFT sets per step.
- **Differentiate**: 2nd-order central differences on the potential grid.
- **Interpolate**: the whole 2x2x2 accel neighborhood packs into one
  32-float row per cell, stored LANE-PACKED as [G³/4, 128] lines (4
  cells per 128-wide line — built directly by `_pack_corner_rows`), so
  trilinear interpolation costs a single row-gather per particle —
  issued through the lane-packed gather (`ops/rowgather.py` with
  `packed_w=32`). The rows must
  stay fp32: the self-field cancellation across corners breaks in bf16
  (see `_accel_rows`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _cic_cells(position: jax.Array, grid: int, box: float):
    """Common CIC geometry: base cell, fractions, in-box mask."""
    g = grid
    h = box / g
    # grid node i sits at x = (i + 0.5 - g/2) * h; CIC base = floor
    u = position[:3] / h + (g / 2 - 0.5)
    i0 = jnp.floor(u).astype(jnp.int32)
    frac = (u - i0).astype(jnp.float32)
    # keep a 1-cell margin so CIC corners and the FD stencil stay in-bounds
    inside = jnp.all((i0 >= 1) & (i0 <= g - 3), axis=0)
    return i0, frac, inside


def _corner_weights(frac):
    """[8, N] trilinear weights in (dz, dy, dx) binary order."""
    ws = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ws.append(
                    (frac[0] if dx else 1.0 - frac[0])
                    * (frac[1] if dy else 1.0 - frac[1])
                    * (frac[2] if dz else 1.0 - frac[2])
                )
    return ws


def _sort_by_cell(position: jax.Array, grid: int, box: float):
    """Sort particles by CIC base cell id.

    Returns (sbase, sfrac): base cell ids ascending (out-of-box and
    padding parked at the ncell sentinel, which sorts last) with the three
    CIC fractions carried as payloads. The 8 corner weights are recomputed
    post-sort — cheaper than carrying 8 sort operands (payloads cost
    per-operand; fractions are 3).
    """
    g = grid
    i0, frac, inside = _cic_cells(position, grid, box)
    ncell = g * g * g
    base = i0[2] * g * g + i0[1] * g + i0[0]
    base = jnp.where(inside, base, ncell)
    sbase, sfx, sfy, sfz = jax.lax.sort(
        (base, frac[0], frac[1], frac[2]),
        dimension=0, num_keys=1, is_stable=False,
    )
    return sbase, (sfx, sfy, sfz)


def _segment_bounds(sbase: jax.Array, ncell: int) -> jax.Array:
    """bounds[c] = #{i : sbase[i] < c} for c in 0..ncell, WITHOUT
    `jnp.searchsorted` (G³ binary searches over N sorted keys).
    Merge-by-sort instead:

    - sort concat(2c for the G³+1 query cells, 2k+1 for the particle keys):
      query c lands immediately BEFORE the keys equal to c (side='left'),
      so its merged position is bounds[c] + c;
    - recover those positions by a second 2-op sort that compacts the even
      (query) entries to the front carrying their merged index.

    Two cheap sorts — bitwise identical bounds to the searchsorted they
    replace.
    """
    m = sbase.shape[0]
    queries = jnp.arange(ncell + 1, dtype=jnp.int32) * 2
    merged = jnp.concatenate([queries, sbase * 2 + 1])
    (ms,) = jax.lax.sort((merged,), dimension=0, num_keys=1, is_stable=False)
    jpos = jnp.arange(m + ncell + 1, dtype=jnp.int32)
    # park particle entries past the largest query key (2*ncell) so the
    # compaction sort brings the ncell+1 query positions to the front in
    # cell order
    kc = jnp.where((ms & 1) == 0, ms, jnp.int32(2 * ncell + 3))
    _, jq = jax.lax.sort((kc, jpos), dimension=0, num_keys=1, is_stable=False)
    return jq[: ncell + 1] - jnp.arange(ncell + 1, dtype=jnp.int32)


def _deposit_sorted(sbase, sfrac, grid: int) -> jax.Array:
    """Sorted cell ids + fractions -> CIC count grid [G, G, G]."""
    g = grid
    ncell = g * g * g
    live = sbase < ncell
    sw8 = jnp.stack(
        [jnp.where(live, w, 0.0) for w in _corner_weights(sfrac)], axis=1
    )                                                  # [N, 8]
    bounds = _segment_bounds(sbase, ncell)
    # all 8 corner weights in ONE cumsum pass + ONE row-gather at the
    # boundaries (vs 8 separate scans and element-gathers)
    from multi_adapter_particles_tpu.ops.rowgather import gather_rows

    csum = jnp.concatenate(
        [jnp.zeros((1, 8), jnp.float32), jnp.cumsum(sw8, axis=0)]
    )                                                  # [N+1, 8]
    at_bounds = gather_rows(csum, bounds)              # [ncell+1, 8] rows
    hist8 = at_bounds[1:] - at_bounds[:-1]             # [ncell, 8]
    rho = jnp.zeros((g, g, g), jnp.float32)
    corner = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                hist = hist8[:, corner].reshape(g, g, g)
                # corner cell = base + (dx, dy, dz): shift the histogram
                rho = rho.at[
                    dz : g, dy : g, dx : g
                ].add(hist[: g - dz, : g - dy, : g - dx])
                corner += 1
    return rho


@functools.partial(jax.jit, static_argnames=("grid", "box"))
def deposit_cic(position: jax.Array, grid: int, box: float) -> jax.Array:
    """[4, N] positions -> CIC count grid [G, G, G] ([z, y, x], unit mass).

    Out-of-box particles (incl. the 1e9 padding) are dropped via a
    sentinel cell id that sorts past the histogram range.
    """
    sbase, sfrac = _sort_by_cell(position, grid, box)
    return _deposit_sorted(sbase, sfrac, grid)


def _potential_kernel_rfft(grid: int, box: float, eps2: float):
    """rfft of phi(r) = -(|r|²+eps²)^{-1/2} on the doubled grid (min-image
    offsets). Pure function of statics — constant-folded under jit."""
    g2 = 2 * grid
    h = box / grid
    m = jnp.arange(g2)
    off = (((m + grid) % g2) - grid).astype(jnp.float32) * h   # [-G, G) * h
    rz = off[:, None, None]
    ry = off[None, :, None]
    rx = off[None, None, :]
    d2 = rx * rx + ry * ry + rz * rz + jnp.float32(eps2)
    return jnp.fft.rfftn(-jax.lax.rsqrt(d2))


def _rfft_pruned(rho: jax.Array, g: int):
    """Forward half of the axis-pruned free-space transform (see
    `_convolve_pruned`): [G, G, G] real -> [2G, 2G, G+1] spectrum."""
    g2 = 2 * g
    f = jnp.fft.rfft(rho, n=g2, axis=2)            # [G, G, G+1]
    f = jnp.fft.fft(f, n=g2, axis=1)               # [G, 2G, G+1]
    return jnp.fft.fft(f, n=g2, axis=0)            # [2G, 2G, G+1]


def _irfft_pruned(f: jax.Array, g: int):
    """Inverse half: [2G, 2G, G+1] spectrum -> [G, G, G] real, slicing
    the padded half of each axis away as soon as it is inverse-done."""
    g2 = 2 * g
    f = jnp.fft.ifft(f, axis=0)[:g]                # [G, 2G, G+1]
    f = jnp.fft.ifft(f, axis=1)[:, :g]             # [G, G, G+1]
    return jnp.fft.irfft(f, n=g2, axis=2)[:, :, :g]


def _convolve_pruned(rho: jax.Array, kernel_rfft: jax.Array, g: int):
    """Free-space convolution on the doubled grid with axis-pruned FFTs.

    `jnp.fft.rfftn` on the zero-padded [2G, 2G, 2G] grid transforms the
    zero half of every axis and inverse-transforms output that is sliced
    away. Doing the axes one at a time prunes both ends:

    forward  (input only [:G, :G, :G] nonzero):
      rfft  axis 2 over G*G REAL pencils        (naive: 2G*2G complex)
      fft   axis 1 over G*(G+1) pencils         (naive: 2G*(G+1))
      fft   axis 0 over 2G*(G+1) pencils        (no saving)
    inverse (output only [:G, :G, :G] kept):
      ifft  axis 0, slice [:G]                  (no saving)
      ifft  axis 1 over G*(G+1) pencils, slice
      irfft axis 2 over G*G pencils, slice

    ~2.5x fewer FFT flops and no materialized [2G, 2G, 2G] zero-pad.
    Bitwise it differs from rfftn only by fp reassociation (same math).
    """
    return _irfft_pruned(_rfft_pruned(rho, g) * kernel_rfft, g)


def _accel_rows(
    rho: jax.Array, grid: int, box: float, g_const: float,
    softening_squared: float,
) -> jax.Array:
    """Field solve + gradient -> lane-packed accel rows [G³/4, 128].

    The whole 2x2x2 corner neighborhood packs into ONE 32-float row per
    base cell (grids are [z, y, x]; cid = z*g*g + y*g + x), so trilinear
    interpolation costs a single row-gather per particle instead of 8;
    4 cells share each 128-lane line (see `_pack_corner_rows`)."""
    phi = _convolve_pruned(
        rho, _potential_kernel_rfft(grid, box, softening_squared), grid
    ) * jnp.float32(g_const)
    return _grad_pack(phi, grid, box)


def _grad_pack(phi: jax.Array, grid: int, box: float) -> jax.Array:
    """Scaled potential [G, G, G] -> lane-packed accel rows [G³/4, 128]
    (the gradient + neighborhood-packing tail of `_accel_rows`, split
    out so the distributed solve can produce `phi` its own way)."""
    g = grid
    h = box / g
    # accel = -grad phi, 2nd-order central differences ([z, y, x] grids)
    inv2h = jnp.float32(1.0 / (2.0 * h))
    zero = jnp.zeros_like(phi)
    ax = zero.at[:, :, 1:-1].set((phi[:, :, :-2] - phi[:, :, 2:]) * inv2h)
    ay = zero.at[:, 1:-1, :].set((phi[:, :-2, :] - phi[:, 2:, :]) * inv2h)
    az = zero.at[1:-1, :, :].set((phi[:-2, :, :] - phi[2:, :, :]) * inv2h)

    # The rows stay fp32: trilinear interpolation at a particle's own
    # location relies on CANCELLATION of its steep self-field across the
    # 8 corners (corner values can be ~300x the far-field signal), and
    # bf16 storage was measured to break it (7.5% two-body far-field
    # error vs <1% in fp32). The smooth long-range kernel of ops/p3m.py
    # has no self-blob and can afford half-width rows; this one cannot.
    return _pack_corner_rows(ax, ay, az, g)


_PACK_SLAB_CELLS = 1 << 20  # cells per _pack_corner_rows slab: bounds
#                             the [slab_cells, 32] transient


def _pack_corner_rows(ax, ay, az, g: int) -> jax.Array:
    """Accel grids [g,g,g] x3 -> LANE-PACKED corner rows [G³/4, 128].

    Line l holds the 32-float rows of cells 4l..4l+3 (8 corners x
    [ax, ay, az, 0] each) — exactly `rows([G³,32]).reshape(G³/4, 128)`,
    the form `rowgather.gather_rows(..., packed_w=32)` consumes, but
    built WITHOUT ever materializing a whole [G³, 32]-shaped value:
    building the packed form slab-by-slab under `lax.map` bounds the
    narrow transient to one z-slab, and the output is G³x128 B.

    Bitwise identical to the old concatenate-then-relayout rows: pure
    copies, same corner order (dz, dy, dx row-major; lane j*32+c*4+comp
    for cell 4l+j, corner c, component comp)."""
    # one z-slab per map step: k planes with k | g, slab cells bounded
    # by _PACK_SLAB_CELLS. m=g (one z-plane per step) always divides g,
    # so the divisor search is clamped there — without the clamp it
    # never terminates once ceil(g³/slab) exceeds g (any g > 1024).
    m = min(-(-g ** 3 // _PACK_SLAB_CELLS), g)
    while g % m:
        m += 1
    k = g // m
    pads = ((0, 1), (0, 1), (0, 1))
    axp, ayp, azp = (jnp.pad(a, pads) for a in (ax, ay, az))
    zeros = jnp.zeros((k * g * g, 1), jnp.float32)
    cells = k * g * g

    def slab(i):
        z0 = i * k
        cols = []
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    for comp in (axp, ayp, azp, None):
                        if comp is None:
                            cols.append(zeros)
                            continue
                        s = jax.lax.dynamic_slice(
                            comp, (z0 + dz, dy, dx), (k, g, g)
                        )
                        cols.append(s.reshape(cells, 1))
        return jnp.concatenate(cols, axis=1).reshape(cells // 4, 128)

    if m == 1:
        return slab(0)
    out = jax.lax.map(slab, jnp.arange(m))
    return out.reshape(g ** 3 // 4, 128)


def _pack_scalar_corner_rows(phi: jax.Array, g: int) -> jax.Array:
    """Scalar grid [g,g,g] -> lane-packed corner rows for trilinear
    interpolation of a SCALAR field (the potential gauge): line l holds
    the 8-float corner rows of cells 16l..16l+15 — [G³/16, 128], the
    `rowgather.gather_rows(..., packed_w=8)` form. Same corner order as
    `_pack_corner_rows` (dz, dy, dx row-major), same slab-by-slab
    construction bounding the [slab_cells, 8] transient; the output is
    32 B/cell, so the potential gauge fits wherever the force rows do.

    Grids whose g³ isn't 16-divisible (g < 4, never produced by
    AUTO_GRID_LADDER) fall back to plain [g³, 8] rows — `gather_rows`
    packs those itself."""
    m = min(-(-g ** 3 // _PACK_SLAB_CELLS), g)
    while g % m:
        m += 1
    k = g // m
    cells = k * g * g
    php = jnp.pad(phi, ((0, 1), (0, 1), (0, 1)))
    packed = cells % 16 == 0
    width = 16 if packed else 1

    def slab(i):
        z0 = i * k
        cols = [
            jax.lax.dynamic_slice(
                php, (z0 + dz, dy, dx), (k, g, g)
            ).reshape(cells, 1)
            for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)
        ]
        return jnp.concatenate(cols, axis=1).reshape(
            cells // width, 8 * width
        )

    if m == 1:
        return slab(0)
    out = jax.lax.map(slab, jnp.arange(m))
    return out.reshape(g ** 3 // width, 8 * width)


def _interp_scalar(rows: jax.Array, position: jax.Array, grid: int,
                   box: float) -> tuple[jax.Array, jax.Array]:
    """Trilinear gather-back of a scalar field -> (values [N], inside [N]).

    `rows` is `_pack_scalar_corner_rows` output. Out-of-box particles get
    0 (they feel/exert no PM field — same contract as `_interp`); the
    `inside` mask is returned so callers can gate per-particle
    corrections (e.g. the self-energy subtraction of the potential
    gauge). Chunked like `_interp` so the [N, 8] intermediate stays
    bounded at multi-million N."""
    from multi_adapter_particles_tpu.ops.rowgather import gather_rows

    g = grid
    n = position.shape[1]
    i0, frac, inside = _cic_cells(position, g, box)
    i0c = jnp.clip(i0, 0, g - 2)
    cid = i0c[2] * g * g + i0c[1] * g + i0c[0]
    w8 = jnp.stack(_corner_weights(frac), axis=1)       # [N, 8]
    packed_w = 8 if rows.shape[1] == 128 else None

    def fused(ci, wi):
        r8 = gather_rows(rows, ci, packed_w=packed_w).reshape(
            ci.shape[0], 8
        )
        return jnp.sum(r8 * wi, axis=1)                 # [chunk]

    if n <= _INTERP_CHUNK:
        val = fused(cid, w8)
    else:
        k = -(-n // _INTERP_CHUNK)
        pad = k * _INTERP_CHUNK - n
        cid_p = (
            jnp.concatenate([cid, jnp.zeros(pad, cid.dtype)]) if pad else cid
        )
        w8_p = (
            jnp.concatenate([w8, jnp.zeros((pad, 8), w8.dtype)]) if pad else w8
        )
        val = jax.lax.map(
            lambda args: fused(*args),
            (cid_p.reshape(k, _INTERP_CHUNK), w8_p.reshape(k, _INTERP_CHUNK, 8)),
        ).reshape(k * _INTERP_CHUNK)[:n]
    return jnp.where(inside, val, 0.0), inside


_INTERP_CHUNK = 2_097_152  # particles per fused gather+weight chunk


def _interp(acc32, position, grid: int, box: float) -> jax.Array:
    """Trilinear gather-back in particle order -> accel [3, N].

    Above `_INTERP_CHUNK` particles the gather+weight+reduce runs fused
    per chunk through `lax.map`, so the [N, 8, 4] gathered-neighborhood
    intermediate (2.1 GB at 16.8M) never materializes — each chunk emits
    its reduced [chunk, 4] directly. Bitwise identical to the one-shot
    path."""
    from multi_adapter_particles_tpu.ops.rowgather import gather_rows

    g = grid
    n = position.shape[1]
    i0, frac, inside = _cic_cells(position, g, box)
    i0c = jnp.clip(i0, 0, g - 2)
    cid = i0c[2] * g * g + i0c[1] * g + i0c[0]
    w8 = jnp.stack(_corner_weights(frac), axis=1)       # [N, 8]

    def fused(ci, wi):
        rows = gather_rows(acc32, ci, packed_w=32).reshape(
            ci.shape[0], 8, 4
        )
        return jnp.sum(rows * wi[:, :, None], axis=1)   # [chunk, 4]

    if n <= _INTERP_CHUNK:
        acc = fused(cid, w8)
    else:
        k = -(-n // _INTERP_CHUNK)
        pad = k * _INTERP_CHUNK - n
        cid_p = jnp.concatenate([cid, jnp.zeros(pad, cid.dtype)]) if pad else cid
        w8_p = (
            jnp.concatenate([w8, jnp.zeros((pad, 8), w8.dtype)]) if pad else w8
        )
        acc = jax.lax.map(
            lambda args: fused(*args),
            (cid_p.reshape(k, _INTERP_CHUNK), w8_p.reshape(k, _INTERP_CHUNK, 8)),
        ).reshape(k * _INTERP_CHUNK, 4)[:n]
    return jnp.where(inside[None, :], acc[:, :3].T, 0.0)


def solve_and_gather(
    rho: jax.Array,       # [G, G, G] deposited counts ([z, y, x])
    position: jax.Array,  # [4, N] — the particles to interpolate onto
    grid: int,
    box: float,
    g_const: float,
    softening_squared: float,
) -> jax.Array:
    """Field solve + gradient + trilinear gather-back -> accel [3, N].

    Split out from `pm_accel` so the sharded step can psum per-shard
    deposits into `rho` and then run this part locally on every device
    (traceable inside shard_map; jit-wrapped by the caller)."""
    acc32 = _accel_rows(rho, grid, box, g_const, softening_squared)
    return _interp(acc32, position, grid, box)


@functools.partial(
    jax.jit, static_argnames=("grid", "box", "g_const", "softening_squared")
)
def pm_accel(
    position: jax.Array,  # [4, N]
    grid: int = 64,
    box: float = 2048.0,
    g_const: float = 1.0,
    softening_squared: float = 25.0,
) -> jax.Array:
    """-> accel [3, N]: isolated-boundary FFT-PM with the all-pairs pair
    law (g_const = SimConfig.mass, same softening)."""
    rho = deposit_cic(position, grid, box)
    return solve_and_gather(
        rho, position, grid=grid, box=box, g_const=g_const,
        softening_squared=softening_squared,
    )


def make_accel_fn(
    mass: float,
    softening_squared: float = 25.0,
    grid: int = 64,
    box: float = 2048.0,
):
    """Adapter matching the integrator's accel_fn signature."""

    def accel_fn(position: jax.Array) -> jax.Array:
        return pm_accel(
            position, grid=grid, box=box, g_const=mass,
            softening_squared=softening_squared,
        )

    return accel_fn
