"""Tile-binned point-sprite splatter.

The reference's draw path is VS -> GS billboard expand -> PS radial sprite ->
alpha blend in ROP hardware (`ParticleDraw.hlsl`, blend state
`Render.cpp:522-532`). XLA has no rasterizer and scatter-heavy
splatting serializes on conflicting writes, so the pipeline is re-shaped
as a *gather*:

1. **Project** all particles (one fused matmul + elementwise pass). Because
   billboards are eye-space axis-aligned squares, each sprite projects to a
   screen-axis-aligned rectangle -> a particle is fully described by
   (center, half-extents, rgb, intensity).
2. **Bin** sprites to (tile_h x tile_w) pixel tiles: each particle emits up
   to DY x DX candidate (tile, id) entries; ONE stable multi-operand sort
   by tile key co-sorts all sprite params as payloads (payloads ride the
   comparator network for free) and orders entries by tile then particle
   id — exactly the draw order of the reference's single DrawInstanced
   call (`Render.cpp:891`), so ordered alpha blending is preserved.
3. **Composite** exactly at ANY depth: over-composition with a per-sprite
   source clamp is associative on (premultiplied color, transmittance), so
   the sorted entry stream splits into Q-ALIGNED data rows (a pure reshape
   — no random gathers); each (data row, tile) intersection is a virtual
   row of one depth-Q pass ([lo, hi) masks select the tile's slice, and a
   boundary row repeats once per tile it straddles), then consecutive rows
   of a tile tree-combine in O(log max_segments) passes. On a GPU the
   depth-Q pass is a register-resident Triton kernel (ops/composite.py);
   elsewhere a lax.scan.

There is no depth cap and nothing is ever dropped; `overflow` is always 0
(kept for the metrics surface). `truncated` counts sprite-tile entries
outside the dup_y x dup_x candidate window (raise dup for huge sprites).

Matches `render/reference.py` (the exact NumPy oracle) to fp32 tolerance;
golden tests in tests/test_render.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multi_adapter_particles_tpu import constants as C
from multi_adapter_particles_tpu.config import RenderConfig
from multi_adapter_particles_tpu.ops.dispatch import TRITON_INTERPRET
from multi_adapter_particles_tpu.render.camera import Camera

# Tile shape: (8, 16) pixels = 128 values per tile. Small tiles matter:
# composite work is (entries x tile_px), and a default sprite covers
# ~25 px, so (8, 128) tiles waste 97% of every blend step while (8, 16)
# wastes ~80%. Sprites spanning more than dup_y x dup_x tiles are
# reported via `truncated` (raise dup for huge-sprite scenes).
TILE_H = 8
TILE_W = 16


class FrameOutput(NamedTuple):
    frame: jax.Array      # [H, W, 3] float32 in [0, 1]
    overflow: jax.Array   # int32 — always 0 (exact composite; metrics API)
    truncated: jax.Array  # int32 — tile entries beyond the dup_y x dup_x
    #                       candidate window (sprites bigger than the dup
    #                       grid; fix by raising dup_y/dup_x)
    span_y: jax.Array     # int32 — max tile rows any live sprite covers
    span_x: jax.Array     # int32 — max tile cols any live sprite covers
    #                       (the dup_y/dup_x a lossless frame needs;
    #                       drives the auto-raise in Renderer.render)
    trans: Optional[jax.Array] = None  # [H, W] transmittance plane — only
    #                       in return_trans mode (the chunked-composite
    #                       fold state; frame then holds UNquantized
    #                       premultiplied color)


def _project(position, wvp, p00, p11, width, height, radius):
    """SoA positions [4, Np] -> screen-space sprite params (all [Np])."""
    x, y, z = position[0], position[1], position[2]
    # row-vector convention: clip = [x y z 1] @ WVP
    cx_clip = x * wvp[0, 0] + y * wvp[1, 0] + z * wvp[2, 0] + wvp[3, 0]
    cy_clip = x * wvp[0, 1] + y * wvp[1, 1] + z * wvp[2, 1] + wvp[3, 1]
    w_clip = x * wvp[0, 3] + y * wvp[1, 3] + z * wvp[2, 3] + wvp[3, 3]
    inv_w = 1.0 / w_clip
    cx = (cx_clip * inv_w + 1.0) * (0.5 * width)
    cy = (1.0 - cy_clip * inv_w) * (0.5 * height)
    hx = radius * p00 * inv_w * (0.5 * width)
    hy = radius * p11 * inv_w * (0.5 * height)
    return cx, cy, hx, hy, w_clip


def _colors(position, num_particles, id_offset=0):
    """VSParticleDraw color rule (`ParticleDraw.hlsl:104-109`), SoA.

    `id_offset` shifts the id-hash channel so a CHUNK of a larger state
    colors exactly as it would in the full draw (chunked renders)."""
    n = position.shape[1]
    ids = jnp.arange(n, dtype=jnp.int32) + id_offset
    mag = position[3] / jnp.float32(C.ACCEL_COLOR_SCALE)
    cold = C.SPRITE_COLOR_COLD
    hot = C.SPRITE_COLOR_HOT
    g = cold[1] + mag * (hot[1] - cold[1])  # unclamped lerp
    b = (ids & C.SPRITE_ID_MASK).astype(jnp.float32) / float(C.SPRITE_ID_MASK)
    r = 1.0 - b
    return r, g, b


_STARTS_CHUNK = 128  # level-1 chunk width of _starts_two_level


def _starts_two_level(sorted_key, num_queries, chunk=None):
    """starts[k] = first i with sorted_key[i] >= k, for k = 0..num_queries-1.

    Equivalent to jnp.searchsorted(sorted_key, arange(nq), side="left"),
    but that lowers to a ~log2(E)-step while loop whose every step randomly
    gathers from the FULL entry array. Two-level instead: bound the query
    into the per-chunk minima (E/chunk elements), then gather ONE boundary
    chunk row per query (ops/rowgather lane-packing) and count its entries
    < k. Sorted order makes the split exact: every entry before chunk c*
    is <= cm[c*] < k, every entry after it is >= cm[c*+1] >= k. Keys are
    integer-valued f32 (exact < 2^24), so comparisons are exact. The
    level-1 bound itself rides pm._segment_bounds' merge-by-sort (two
    ~(E/chunk + nq)-element sorts) rather than searchsorted over the
    minima, which would be another ~15-step while loop of gathers —
    bitwise-identical starts."""
    if chunk is None:
        chunk = _STARTS_CHUNK
    e = sorted_key.shape[0]
    q = jnp.arange(num_queries, dtype=jnp.int32).astype(sorted_key.dtype)
    if not chunk or e % chunk:
        return jnp.searchsorted(sorted_key, q, side="left").astype(jnp.int32)
    from multi_adapter_particles_tpu.ops.pm import _segment_bounds
    from multi_adapter_particles_tpu.ops.rowgather import gather_rows

    cm = sorted_key[::chunk]                              # [E/chunk]
    cstar = _segment_bounds(cm.astype(jnp.int32), num_queries - 1) - 1
    cc = jnp.maximum(cstar, 0)                            # clip: all-minima>=k
    rows = gather_rows(sorted_key.reshape(e // chunk, chunk), cc)
    cnt = jnp.sum((rows < q[:, None]).astype(jnp.int32), axis=1)
    return cc * chunk + cnt


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "seg_q", "dup_y", "dup_x", "near", "blend",
        "composite", "frame_uint8", "return_trans",
        "starts_chunk",
    ),
)
def _render(
    position: jax.Array,   # [4, Np]
    wvp: jax.Array,        # [4, 4] world-view-projection (row-vector)
    p00: jax.Array,        # proj[0, 0]
    p11: jax.Array,        # proj[1, 1]
    radius: jax.Array,     # particle size (eye units)
    intensity: jax.Array,  # sprite intensity
    num_draw: jax.Array,   # dynamic draw count (decoupling knob)
    id_offset: jax.Array = 0,  # global id of column 0 (chunked renders)
    *,
    width: int,
    height: int,
    seg_q: int,            # sprites per segment row (perf knob, not coverage)
    dup_y: int,
    dup_x: int,
    near: float,
    blend: str,            # 'over' (exact) | 'additive' (order-free)
    composite: str = "xla",  # ops/dispatch.composite_impl
    frame_uint8: bool = False,
    return_trans: bool = False,
    starts_chunk: Optional[int] = None,  # None -> module default
) -> FrameOutput:
    n = position.shape[1]
    gh, gw = height // TILE_H, width // TILE_W
    num_tiles = gh * gw
    dup = dup_y * dup_x

    cx, cy, hx, hy, w_clip = _project(
        position, wvp, p00, p11, float(width), float(height), radius
    )
    cr, cg, cb = _colors(position, n, id_offset)

    ids = jnp.arange(n, dtype=jnp.int32)
    alive = (ids < num_draw) & (w_clip > jnp.float32(near))

    # Sprite pixel rect [x0, x1) x [y0, y1); pixel centers at +0.5.
    x0 = cx - hx
    x1 = cx + hx
    y0 = cy - hy
    y1 = cy + hy
    px0 = jnp.maximum(jnp.ceil(x0 - 0.5), 0.0).astype(jnp.int32)
    px1 = jnp.minimum(jnp.ceil(x1 - 0.5), width).astype(jnp.int32)
    py0 = jnp.maximum(jnp.ceil(y0 - 0.5), 0.0).astype(jnp.int32)
    py1 = jnp.minimum(jnp.ceil(y1 - 0.5), height).astype(jnp.int32)
    nonempty = (px0 < px1) & (py0 < py1) & alive

    tx0 = px0 // TILE_W
    tx1 = (px1 - 1) // TILE_W
    ty0 = py0 // TILE_H
    ty1 = (py1 - 1) // TILE_H

    # Candidate tiles: (ty0 + dy, tx0 + dx). Sprites spanning more tiles than
    # dup_y x dup_x lose their far tiles -> counted in `truncated` below.
    # Keys are built as dup FLAT [Np] planes (dense layouts, where an
    # [Np, dup_y, dup_x] formulation pads its two short minor dims),
    # as f32 (tile ids < 2^24 are exact; an f32 key sorts identically and
    # rides the same all-f32 comparator network).
    key_planes = []
    for dy in range(dup_y):
        for dx in range(dup_x):
            typ = ty0 + dy
            txp = tx0 + dx
            okp = nonempty & (typ <= ty1) & (txp <= tx1)
            key_planes.append(
                jnp.where(okp, (typ * gw + txp).astype(jnp.float32),
                          jnp.float32(num_tiles))
            )
    truncated = jnp.sum(
        jnp.maximum(ty1 - ty0 + 1 - dup_y, 0) * (tx1 - tx0 + 1)
        + jnp.maximum(tx1 - tx0 + 1 - dup_x, 0)
        * jnp.minimum(ty1 - ty0 + 1, dup_y),
        where=nonempty,
        initial=0,
    )
    span_y = jnp.max(ty1 - ty0 + 1, where=nonempty, initial=0)
    span_x = jnp.max(tx1 - tx0 + 1, where=nonempty, initial=0)

    # Multi-operand stable sort carries the sprite params as payloads — one
    # sorting network instead of argsort + chains of random gathers.
    # Payloads are NOT free (each one is another operand every comparator
    # stage moves), so carry the MINIMUM 4 and derive the rest after the
    # sort on the Q-aligned rows:
    #   - 1/(2hx), 1/(2hy) are linear in w_clip (hx = radius*p00*W/2 / w),
    #     so carry w_clip once and scale by per-frame scalars;
    #   - cr = 1 - cb (the VS color rule);
    #   - (cg, cb) pack as two f16 halves of one u32 lane (~2.5e-4 color
    #     error, an order below the golden-test tolerance).
    # Degenerate sprites (size 0, or w_clip == 0 at the eye plane) never
    # bin to a tile, but their params still ride the sort as payloads of
    # sentinel entries; NaN/Inf there would poison composite pixels
    # through `x * 0 == NaN`, so sanitize the geometry params (post-sort
    # for the w-derived extents).
    cx = jnp.nan_to_num(cx, nan=0.0, posinf=0.0, neginf=0.0)
    cy = jnp.nan_to_num(cy, nan=0.0, posinf=0.0, neginf=0.0)
    # clamp cg below f16-inf: the blend clips source terms to [0, 1] anyway,
    # and an f16 inf would NaN-poison dead slots through `inf * 0`
    cgc = jnp.clip(cg, 0.0, 6.0e4)

    def pack_cgb(gv, bv):  # (cg, cb) f32 -> two f16 halves of one u32 lane
        return (
            jnp.left_shift(
                gv.astype(jnp.float16).view(jnp.uint16).astype(jnp.uint32),
                16,
            )
            | bv.astype(jnp.float16).view(jnp.uint16).astype(jnp.uint32)
        ).view(jnp.float32)

    def expand(a):  # per-particle [Np] -> per-entry [E] (dup consecutive)
        return jnp.broadcast_to(a[:, None], (n, dup)).reshape(-1)

    # Entry expansion (e = p*dup + k). The broadcast->reshape form writes
    # [Np, dup] tiles with a short, padded minor dim; when dup divides 128
    # the interleave is instead ONE exact 0/1 permutation matmul per
    # operand: out2d[r, c] =
    # in[r*g + c//dup] (payloads) and key2d[r, c] = plane[c%dup][r*g +
    # c//dup] (keys), g = 128//dup. Selection through >=HIGH precision is
    # bit-exact for f32 VALUES. The packed cgb channel is a bit PATTERN
    # (f16 pair) whose denormal encodings a matmul would flush, so it is
    # expanded as its two UNPACKED f32 halves and packed per-entry after —
    # bitwise-equal (cgc/cb are non-negative, and any positive f32 denormal
    # converts to f16 +0 whether or not the matmul flushed it first).
    # Whether this beats the plain broadcast on the GPU is open (ROADMAP
    # D5).
    if dup == 1:
        key = key_planes[0]
        e_cx, e_cy, e_w = cx, cy, w_clip
        e_cgb = pack_cgb(cgc, cb)
    elif 128 % dup == 0 and (n * dup) % 128 == 0:
        g = 128 // dup
        rows_e = (n * dup) // 128
        pexp = np.zeros((g, 128), np.float32)
        pkey = np.zeros((128, 128), np.float32)
        for j in range(g):
            for k in range(dup):
                pexp[j, j * dup + k] = 1.0
                pkey[k * g + j, j * dup + k] = 1.0
        pexp = jnp.asarray(pexp)
        pkey = jnp.asarray(pkey)

        def _mm(a2, p):
            return jax.lax.dot_general(
                a2, p, (((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
            ).reshape(-1)

        key = _mm(
            jnp.concatenate(
                [p.reshape(rows_e, g) for p in key_planes], axis=1
            ),
            pkey,
        )
        e_cx = _mm(cx.reshape(rows_e, g), pexp)
        e_cy = _mm(cy.reshape(rows_e, g), pexp)
        e_w = _mm(w_clip.reshape(rows_e, g), pexp)
        e_cgb = pack_cgb(
            _mm(cgc.reshape(rows_e, g), pexp), _mm(cb.reshape(rows_e, g), pexp)
        )
    else:
        key = jnp.stack(key_planes, axis=1).reshape(-1)
        e_cx, e_cy, e_w = expand(cx), expand(cy), expand(w_clip)
        e_cgb = expand(pack_cgb(cgc, cb))

    (sorted_key, s_cx, s_cy, s_w, s_cgb) = jax.lax.sort(
        (key, e_cx, e_cy, e_w, e_cgb),
        dimension=0, num_keys=1, is_stable=True,
    )

    starts = _starts_two_level(sorted_key, num_tiles + 1, chunk=starts_chunk)
    counts = starts[1:] - starts[:-1]                     # [T]

    # ---- exact segmented composite -----------------------------------------
    # Over-composition with a per-sprite source clamp is ASSOCIATIVE on
    # (premultiplied color C, transmittance T): later ∘ earlier =
    # (C_l + C_e * T_l, T_e * T_l). So the sorted entry stream splits into
    # Q-ALIGNED data rows (a pure reshape of the co-sorted param arrays —
    # no random gathers); each (data row, tile) pair that intersects is one
    # "virtual row" of a single depth-Q scan, with a [lo, hi) valid mask
    # selecting the tile's slice of the row. Boundary rows appear once per
    # tile they straddle, so V <= T + E/Q as before. Total work ∝ actual
    # entries + T*Q with NO per-tile depth cap — a 65K-sprite cluster-core
    # tile just contributes 65K/Q rows — then consecutive virtual rows of a
    # tile tree-combine in O(log(max_segments)) passes. Exact at any depth.
    px_count = TILE_H * TILE_W
    e_total = n * dup
    q = seg_q
    data_rows = -(-e_total // q)           # ceil: sorted stream, Q-aligned
    e_pad = data_rows * q - e_total        # tail padding (beyond all ends)
    max_segs = data_rows + 1               # one tile could span everything
    num_rows = num_tiles + data_rows       # static bound on virtual rows

    ends = starts[1:]
    j_lo = starts[:-1] // q                          # first data row of tile
    j_hi = jnp.where(counts > 0, (ends - 1) // q, j_lo)  # last (inclusive)
    segs = jnp.where(counts > 0, j_hi - j_lo + 1, 1)     # empty -> 1 dummy
    row_end = jnp.cumsum(segs).astype(jnp.int32)     # [T]
    row_start = (row_end - segs).astype(jnp.int32)
    v = jnp.arange(num_rows, dtype=jnp.int32)

    # Virtual-row -> tile map by MERGE, not binary search (a searchsorted
    # while-loop of random gathers plus follow-up per-row gathers).
    # row_end is sorted and distinct and v is the
    # dense range, so ONE stable 32K sort interleaves boundary markers
    # with the queries (marker-before-query at ties = side="right"), a
    # cumsum of the marker flag yields tile_v, and marker-carried DELTA
    # payloads prefix-sum to the per-tile values the old code gathered:
    #   sum counts[t]   over markers passed = starts[tile_v]
    #   sum counts[t+1] over markers passed = starts[tile_v+1] - starts[1]
    #   sum segs[t]     over markers passed = row_start[tile_v]
    # A second flag-keyed stable sort compacts the query slots back to v
    # order. Queries carry zero deltas, so inclusive scans are exact.
    zq = jnp.zeros((num_rows,), jnp.int32)
    mkey = jnp.concatenate([row_end, v])
    mflag = jnp.concatenate(
        [jnp.ones((num_tiles,), jnp.int32), zq]
    )
    d_sta = jnp.concatenate([counts, zq])
    d_end = jnp.concatenate(
        [counts[1:], jnp.zeros((1,), jnp.int32), zq]
    )
    d_rs = jnp.concatenate([segs.astype(jnp.int32), zq])
    _, sf, sd1, sd2, sd3 = jax.lax.sort(
        (mkey, mflag, d_sta, d_end, d_rs),
        dimension=0, num_keys=1, is_stable=True,
    )
    _, tile_m, s1m, s2m, s3m = jax.lax.sort(
        (
            sf,
            jnp.cumsum(sf),
            jnp.cumsum(sd1),
            jnp.cumsum(sd2),
            jnp.cumsum(sd3),
        ),
        dimension=0, num_keys=1, is_stable=True,
    )
    tile_v = tile_m[:num_rows]
    starts_v = s1m[:num_rows]
    ends_v = s2m[:num_rows] + starts[1]
    row_start_v = s3m[:num_rows]

    valid_v = v < row_end[-1]
    tile_vc = jnp.clip(tile_v, 0, num_tiles - 1)
    counts_v = ends_v - starts_v
    seg_v = v - row_start_v
    j_v = starts_v // q + seg_v                      # data row index [V]
    lo_k = jnp.clip(starts_v - j_v * q, 0, q)
    hi_k = jnp.clip(ends_v - j_v * q, 0, q)
    hi_k = jnp.where(valid_v & (counts_v > 0), hi_k, 0)

    kk = jnp.arange(q, dtype=jnp.int32)
    # entry-valid mask built directly in the composite's [Q, V] layout
    valid_k = (kk[:, None] >= lo_k[None, :]) & (kk[:, None] < hi_k[None, :])
    t_sa = jnp.where(valid_k, intensity, 0.0)  # [Q, V]; dead slots blend 0

    # ONE packed row-gather: interleave the 4 sorted payloads per data row
    # ([data_rows, 4*Q] rows), gather j_v once, then a single transpose to
    # the [chan, Q, V] composite layout, instead of 8 separate row-gathers
    # + stack + transpose.
    payload = jnp.stack([s_cx, s_cy, s_w, s_cgb], axis=1)       # [E, 4]
    if e_pad:
        # tail pad: beyond every tile's `ends`, never selected by masks
        payload = jnp.concatenate(
            [payload, jnp.zeros((e_pad, 4), payload.dtype)]
        )
    packed = payload.reshape(data_rows, q, 4)
    packed = packed.transpose(0, 2, 1).reshape(data_rows, 4 * q)
    spt = packed[j_v].reshape(num_rows, 4, q).transpose(1, 2, 0)  # [4, Q, V]

    # post-sort derivations on the [Q, V] planes (see sort comment above)
    inv_sx = 1.0 / (radius * p00 * jnp.float32(width))
    inv_sy = 1.0 / (radius * p11 * jnp.float32(height))
    t_cx, t_cy, t_w = spt[0], spt[1], spt[2]
    t_ihx = jnp.nan_to_num(
        t_w * inv_sx, nan=0.0, posinf=0.0, neginf=0.0
    )
    t_ihy = jnp.nan_to_num(
        t_w * inv_sy, nan=0.0, posinf=0.0, neginf=0.0
    )
    t_u = spt[3].view(jnp.uint32)
    t_cb = (
        (t_u & jnp.uint32(0xFFFF)).astype(jnp.uint16)
        .view(jnp.float16).astype(jnp.float32)
    )
    t_cg = (
        jnp.right_shift(t_u, 16).astype(jnp.uint16)
        .view(jnp.float16).astype(jnp.float32)
    )
    t_cr = 1.0 - t_cb
    xs = (t_cx, t_cy, t_ihx, t_ihy, t_cr, t_cg, t_cb, t_sa)

    if composite != "xla":
        # register-resident composite kernel: params in, (rgb, T) rows
        # out — no per-step device-memory round trip of the carry planes
        from multi_adapter_particles_tpu.ops.composite import (
            composite_rows_triton,
        )

        bases = jnp.stack(
            [
                ((tile_vc % gw) * TILE_W).astype(jnp.float32),
                ((tile_vc // gw) * TILE_H).astype(jnp.float32),
            ]
        )                               # [2, V] — arithmetic, no gather
        cr_v, cg_v, cb_v, tv = composite_rows_triton(
            jnp.stack(xs), bases, hi_k, TILE_H, TILE_W, blend=blend,
            interpret=composite == TRITON_INTERPRET,
        )
    else:
        # per-row pixel-center planes, derived arithmetically
        ly = jax.lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 0)
        lx = jax.lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 1)
        pxc_v = (
            ((tile_vc % gw) * TILE_W)[:, None] + lx.reshape(-1)[None, :]
        ).astype(jnp.float32) + 0.5
        pyc_v = (
            ((tile_vc // gw) * TILE_H)[:, None] + ly.reshape(-1)[None, :]
        ).astype(jnp.float32) + 0.5

        def step(carry, sprite):
            # per-channel [V, px] planes: no [V, 3, px] padding
            # waste, no per-step stack/relayout
            crb, cgb, cbb, tbuf = carry
            scx, scy, sihx, sihy, sr, sg, sb, ssa = sprite  # each [V]
            du = (pxc_v - scx[:, None]) * sihx[:, None]     # (px-cx)/(2hx)
            dv = (pyc_v - scy[:, None]) * sihy[:, None]
            dist = jnp.sqrt(du * du + dv * dv)
            alpha = jnp.clip(0.5 - dist, 0.0, 0.5) * ssa[:, None]  # [V, px]
            if blend == "over":
                keep = 1.0 - alpha
                crb = crb * keep + jnp.clip(sr[:, None] * alpha, 0.0, 1.0)
                cgb = cgb * keep + jnp.clip(sg[:, None] * alpha, 0.0, 1.0)
                cbb = cbb * keep + jnp.clip(sb[:, None] * alpha, 0.0, 1.0)
                tbuf = tbuf * keep
            else:  # additive
                crb = crb + jnp.clip(sr[:, None] * alpha, 0.0, 1.0)
                cgb = cgb + jnp.clip(sg[:, None] * alpha, 0.0, 1.0)
                cbb = cbb + jnp.clip(sb[:, None] * alpha, 0.0, 1.0)
            return (crb, cgb, cbb, tbuf), None

        zero = jnp.zeros((num_rows, px_count), jnp.float32)
        one = jnp.ones((num_rows, px_count), jnp.float32)
        (cr_v, cg_v, cb_v, tv), _ = jax.lax.scan(
            step, (zero, zero, zero, one), xs
        )

    # tree-combine segment rows (consecutive rows share a tile)
    # per-row segment count, derived elementwise from the merged prefixes
    # (identical to segs[tile_vc] for every valid row; invalid rows get 1,
    # which disables partner takes — their contents are never read)
    segs_v = jnp.where(
        counts_v > 0, (ends_v - 1) // q - starts_v // q + 1, 1
    )
    passes = max(max_segs - 1, 0).bit_length()
    chans = [cr_v, cg_v, cb_v]
    for p in range(passes):
        s = 1 << p
        take = ((seg_v % (2 * s) == 0) & (seg_v + s < segs_v))[:, None]
        part_t = jnp.concatenate(
            [tv[s:], jnp.ones((s, px_count), jnp.float32)], axis=0
        )
        for c in range(3):
            part_c = jnp.concatenate(
                [chans[c][s:], jnp.zeros((s, px_count), jnp.float32)], axis=0
            )
            if blend == "over":
                # this row = earlier segments, partner = later: later on top
                chans[c] = jnp.where(
                    take, chans[c] * part_t + part_c, chans[c]
                )
            else:
                chans[c] = jnp.where(take, chans[c] + part_c, chans[c])
        if blend == "over":
            tv = jnp.where(take, tv * part_t, tv)

    # segment-0 row holds each tile's composite
    frame_t = jnp.stack([c[row_start] for c in chans], axis=1)  # [T, 3, px]
    overflow = jnp.int32(0)  # the segmented composite is exact — kept for API

    def assemble(t, ch):  # [T, ch, th*tw] -> [H, W, ch] (or [H, W])
        t = t.reshape(gh, gw, ch, TILE_H, TILE_W)
        t = t.transpose(0, 3, 1, 4, 2).reshape(height, width, ch)
        return t[..., 0] if ch == 1 else t

    if return_trans:
        # chunked-composite mode: UNclipped premultiplied color + the
        # transmittance plane; the caller folds chunks associatively
        # ((C_later + C_earlier*T_later, T_earlier*T_later)) and clips
        # once at the end
        frame = assemble(frame_t, 3)
        trans = assemble(tv[row_start][:, None, :], 1)
        return FrameOutput(
            frame, overflow.astype(jnp.int32), truncated.astype(jnp.int32),
            span_y.astype(jnp.int32), span_x.astype(jnp.int32), trans,
        )

    frame_t = jnp.clip(frame_t, 0.0, 1.0)
    frame = assemble(frame_t, 3)
    if frame_uint8:
        # the reference swap chain's R8G8B8A8_UNORM analog
        # (`Render.cpp:292` DXGI format): quantize on device — 4x smaller
        # HBM frame and 4x cheaper host pulls (dashboard/dumpframe)
        frame = (frame * 255.0 + 0.5).astype(jnp.uint8)
    return FrameOutput(
        frame, overflow.astype(jnp.int32), truncated.astype(jnp.int32),
        span_y.astype(jnp.int32), span_x.astype(jnp.int32),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "width", "height", "seg_q", "dup_y", "dup_x", "near",
        "blend", "composite", "frame_uint8", "starts_chunk",
    ),
)
def _render_mesh(
    position: jax.Array,   # [4, Np] GLOBAL, particle-axis sharded
    wvp: jax.Array,
    p00: jax.Array,
    p11: jax.Array,
    radius: jax.Array,
    intensity: jax.Array,
    num_draw: jax.Array,   # GLOBAL draw count (id-prefix)
    *,
    mesh,
    width: int,
    height: int,
    seg_q: int,
    dup_y: int,
    dup_x: int,
    near: float,
    blend: str,
    composite: str = "xla",  # ops/dispatch.composite_impl
    frame_uint8: bool = False,
    starts_chunk: Optional[int] = None,
) -> FrameOutput:
    """Mesh-sharded frame: each device rasterizes its id-contiguous shard
    to a premultiplied (color, transmittance) pair, then the pairs fold
    through the associative over-composite in id order — the
    `_render_chunked` fold at chunk = shard width, with the chunks living
    on different devices instead of different dispatches. The reference
    can only COPY all positions to its one render adapter each frame
    (`Render.cpp:814`); here the render role itself scales over the mesh."""
    from jax.sharding import PartitionSpec as P

    from multi_adapter_particles_tpu.parallel.mesh import particle_spec

    names = tuple(mesh.axis_names)
    d = int(np.prod([mesh.shape[a] for a in names]))
    n = position.shape[1]
    cn = n // d

    def local(chunk, wvp, p00, p11, radius, intensity, num_draw):
        # flat shard index in the slice-major order of particle_sharding
        idx = jnp.int32(0)
        for name in names:
            idx = idx * mesh.shape[name] + jax.lax.axis_index(name)
        off = idx * jnp.int32(cn)
        nd = jnp.clip(num_draw - off, 0, cn).astype(jnp.int32)
        out = _render(
            chunk, wvp, p00, p11, radius, intensity, nd, off,
            width=width, height=height, seg_q=seg_q, dup_y=dup_y,
            dup_x=dup_x, near=near, blend=blend,
            composite=composite,
            return_trans=True, starts_chunk=starts_chunk,
        )
        return (out.frame[None], out.trans[None], out.truncated[None],
                out.span_y[None], out.span_x[None])

    lead = P(names)  # leading dim sharded over ALL mesh axes, slice-major
    cs, ts, truncs, spans_y, spans_x = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(particle_spec(mesh), P(), P(), P(), P(), P(), P()),
        out_specs=(lead, lead, lead, lead, lead),
        # the body is purely per-device (the only cross-device traffic is
        # the declared out_specs gather); _render's scan carries start
        # from unvarying constants, which the vma check would reject
        check_vma=False,
    )(position, wvp, p00, p11, radius, intensity, num_draw)

    # id-ordered left fold — identical association to _render_chunked
    cf, tf = cs[0], ts[0]
    trunc, sy, sx = truncs[0], spans_y[0], spans_x[0]
    for i in range(1, d):
        cf = cs[i] + cf * ts[i][..., None]
        tf = tf * ts[i]
        trunc = trunc + truncs[i]
        sy = jnp.maximum(sy, spans_y[i])
        sx = jnp.maximum(sx, spans_x[i])
    frame = jnp.clip(cf, 0.0, 1.0)
    if frame_uint8:
        frame = (frame * 255.0 + 0.5).astype(jnp.uint8)
    # replicate the folded outputs: on a multi-process mesh this is what
    # makes the frame readable on EVERY host (present/dashboard), and on
    # one process it pins the gather the fold implies anyway
    rep = jax.sharding.NamedSharding(mesh, P())
    frame, trunc, sy, sx = (
        jax.lax.with_sharding_constraint(x, rep)
        for x in (frame, trunc, sy, sx)
    )
    return FrameOutput(frame, jnp.int32(0), trunc, sy, sx)


def _chunk_width(n: int, chunk_size: int):
    """(k, cn): k lane-aligned chunks of width cn covering n particles.

    No exact-divisor requirement — an N with no divisor near
    ceil(n/chunk_size) (e.g. 2*prime) must not degenerate into millions
    of tiny dispatches; the last chunk carries a parked-padding tail."""
    k = -(-n // chunk_size)
    cn = -(-(-(-n // k)) // 128) * 128
    k = -(-n // cn)
    return k, cn


def _chunked_fold(
    position, wvp, p00, p11, size, intensity, num_draw,
    *, width, height, seg_q, dup_y, dup_x, near, blend,
    composite, chunk_size, frame_uint8, starts_chunk=None,
) -> FrameOutput:
    """Fold id-ordered particle chunks through the associative composite:
    later ∘ earlier = (C_l + C_e T_l, T_e T_l). Each chunk renders with
    its global id offset (colors) and its slice of the num_draw prefix;
    equals the single-pass frame up to fp reassociation of the per-pixel
    blend. Traceable — `num_draw` may be None, an int, or a traced scalar
    (the fused frame program routes its >chunk_threshold renders here so
    the single-program mode gets the same k-smaller-sorts win as split
    mode; a traced num_draw must not force a Python int())."""
    n = position.shape[1]
    k, cn = _chunk_width(n, chunk_size)
    if k * cn > n:
        from multi_adapter_particles_tpu.models.state import PAD_POSITION

        pad = jnp.full((4, k * cn - n), PAD_POSITION, position.dtype)
        pad = pad.at[3, :].set(0.0)
        position = jnp.concatenate([position, pad], axis=1)
    nd_global = jnp.asarray(
        n if num_draw is None else num_draw, jnp.int32
    )

    cf = tf = trunc = sy = sx = None
    for i in range(k):
        chunk = jax.lax.slice_in_dim(position, i * cn, (i + 1) * cn, axis=1)
        nd = jnp.clip(nd_global - jnp.int32(i * cn), 0, cn)
        out = _render(
            chunk, wvp, p00, p11,
            jnp.float32(size), jnp.float32(intensity),
            nd, jnp.int32(i * cn),
            width=width, height=height, seg_q=seg_q,
            dup_y=dup_y, dup_x=dup_x, near=near,
            blend=blend,
            composite=composite,
            return_trans=True,
            starts_chunk=starts_chunk,
        )
        if cf is None:
            cf, tf = out.frame, out.trans
            trunc, sy, sx = out.truncated, out.span_y, out.span_x
        else:
            cf = out.frame + cf * out.trans[..., None]
            tf = tf * out.trans
            trunc = trunc + out.truncated
            sy = jnp.maximum(sy, out.span_y)
            sx = jnp.maximum(sx, out.span_x)
    frame = jnp.clip(cf, 0.0, 1.0)
    if frame_uint8:
        frame = (frame * 255.0 + 0.5).astype(jnp.uint8)
    return FrameOutput(frame, jnp.int32(0), trunc, sy, sx)


class Renderer:
    """Headless splat renderer with reference semantics.

    The composite is exact at any tile depth (segmented associative
    over-composition — see `_render`); `seg_q` is a pure performance knob
    (sprites per segment row). `last_overflow` is always 0 and kept only
    for the metrics surface; `last_truncated` reports sprites larger than
    the dup_y x dup_x tile window (fix by raising those).
    """

    def __init__(
        self,
        config: Optional[RenderConfig] = None,
        seg_q: Optional[int] = None,
        dup_y: int = 2,
        dup_x: int = 2,
        blend: str = "over",
        auto_raise_dup: bool = True,
    ):
        """seg_q None = adaptive: ~half the mean entries/tile, clamped to
        [32, 256] (measured optimum scales with particle density: Q=64 best
        at 262K, Q=256 best at 4M — per-row bookkeeping dominates small Q,
        tail padding dominates large Q)."""
        self.config = config or RenderConfig()
        if self.config.width % TILE_W or self.config.height % TILE_H:
            raise ValueError(
                f"width must be a multiple of {TILE_W} and height of {TILE_H}"
            )
        self.seg_q = seg_q
        self.dup_y = dup_y
        self.dup_x = dup_x
        self.blend = blend
        # depth-Q composite implementation for this platform: the Triton
        # kernel on a GPU, the XLA scan elsewhere (ops/dispatch.py)
        from multi_adapter_particles_tpu.ops.dispatch import composite_impl

        self.composite = composite_impl()
        # Two-level tile-starts search width (None = module default;
        # 0 = plain jnp.searchsorted, kept for A/B measurement)
        self.starts_chunk: Optional[int] = None
        # When a frame reports truncation (a sprite spans more tiles than
        # the dup window — GUI size slider up to 10 with a close camera),
        # grow dup_y/dup_x to the frame's measured max span so the NEXT
        # render is lossless (one recompile per growth). `render()` also
        # re-renders the same frame immediately.
        self.auto_raise_dup = auto_raise_dup
        self.last_overflow = 0
        self.last_truncated = 0
        # Per-frame scalar/device-argument cache: a static camera and
        # unchanged size/intensity re-dispatch the same device scalars
        # every frame instead of ~6 small host->device transfers.
        self._arg_key = None
        self._arg_dev = None
        # Chunked-composite sizing: states above the threshold render in
        # `chunk_size`-particle chunks (bounded memory at any N, and k
        # smaller sorts can beat one big one once per-chunk fixed costs
        # are amortized). Chunked frames equal single-pass ones up to
        # fold reassociation. Both values are tuned, not limits; they
        # have not been re-swept on the GPU yet (ROADMAP S5).
        self.chunk_threshold = 3_145_728
        self.chunk_size = 1_048_576
        # Auto-raise budget: dup growth may not push N x dup sort entries
        # past this (see raise_dup_for). One entry costs ~256 bytes of
        # device memory across the sort operands, payload rows and
        # composite planes, so the budget is the device memory / 256.
        from multi_adapter_particles_tpu.ops.dispatch import (
            memory_limit_bytes,
        )

        self.entry_budget = memory_limit_bytes() // 256
        self._last_n = 0
        # particles per sort dispatch of the LAST render: == _last_n for
        # single-pass frames, the chunk width for chunked ones (drives the
        # auto-raise budget — chunked frames sort chunk-sized batches)
        self._last_sort_n = 0

    def resolve_seg_q(self, n: int, seg_q: Optional[int] = None) -> int:
        """Adaptive segment size: ~half the mean entries per tile, [32, 256]."""
        q = seg_q or self.seg_q
        if q is not None:
            return q
        cfg = self.config
        tiles = (cfg.width // TILE_W) * (cfg.height // TILE_H)
        density = n * self.dup_y * self.dup_x // max(tiles, 1)
        q = 32
        while q < 256 and q * 2 <= density // 2:
            q *= 2
        return q

    def render_arrays(
        self,
        position: jax.Array,
        camera: Camera,
        particle_size: float,
        particle_intensity: float,
        num_draw: Optional[int] = None,
        seg_q: Optional[int] = None,
    ) -> FrameOutput:
        """One jitted render dispatch (no host sync). States larger than
        `chunk_threshold` render in id-ordered chunks folded through the
        associative (color, transmittance) composite — bounded memory at
        any N."""
        self._last_n = position.shape[1]
        if position.shape[1] > self.chunk_threshold:
            return self._render_chunked(
                position, camera, particle_size, particle_intensity,
                num_draw, seg_q,
            )
        self._last_sort_n = position.shape[1]
        cfg = self.config
        n = position.shape[1]
        q = self.resolve_seg_q(n, seg_q)
        return _render(
            position,
            *self._device_args(
                camera, particle_size, particle_intensity,
                int(n if num_draw is None else num_draw),
            ),
            width=cfg.width,
            height=cfg.height,
            seg_q=q,
            dup_y=self.dup_y,
            dup_x=self.dup_x,
            near=cfg.near,
            blend=self.blend,
            composite=self.composite,
            frame_uint8=cfg.frame_uint8,
            starts_chunk=self.starts_chunk,
        )

    def render_mesh(
        self,
        position: jax.Array,
        camera: Camera,
        particle_size: float,
        particle_intensity: float,
        mesh,
        num_draw: Optional[int] = None,
        seg_q: Optional[int] = None,
    ) -> FrameOutput:
        """Mesh-sharded frame (see `_render_mesh`): the particle axis is
        split over the mesh, every device rasterizes its own shard, and
        one gather of (color, transmittance) image pairs replaces the
        reference's full-position copy to the render adapter
        (`Render.cpp:814`) — frame traffic is O(pixels x devices),
        independent of N. Exact at any depth: the per-shard results fold
        with the same association as `_render_chunked` at
        chunk = N / num_devices, so the chunked single-device frame is
        reproduced to ~1 ULP at a matching partition (only compiler
        fusion choices differ)."""
        cfg = self.config
        n = position.shape[1]
        d = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        if n % (d * 128):
            raise ValueError(
                f"render_mesh needs the padded particle count ({n}) "
                f"divisible by devices x lanes ({d} x 128); pad the state "
                "(models/state.py pads to 128 lanes — choose a mesh whose "
                "size divides the lane count)"
            )
        cn = n // d
        self._last_n = n
        self._last_sort_n = cn
        proj = camera.projection_matrix(cfg.aspect, cfg.fov_y, cfg.near,
                                        cfg.far)
        wvp = camera.world_view_projection(
            cfg.aspect, fov_y=cfg.fov_y, near=cfg.near, far=cfg.far
        )
        q = self.resolve_seg_q(cn, seg_q)
        nd = int(n if num_draw is None else num_draw)
        return _render_mesh(
            position,
            jnp.asarray(wvp),
            jnp.float32(abs(proj[0, 0])),
            jnp.float32(abs(proj[1, 1])),
            jnp.float32(particle_size),
            jnp.float32(particle_intensity),
            jnp.int32(nd),
            mesh=mesh,
            width=cfg.width,
            height=cfg.height,
            seg_q=q,
            dup_y=self.dup_y,
            dup_x=self.dup_x,
            near=cfg.near,
            blend=self.blend,
            composite=self.composite,
            frame_uint8=cfg.frame_uint8,
            starts_chunk=self.starts_chunk,
        )

    def _device_args(self, camera, particle_size, particle_intensity,
                     nd: int):
        """Camera/scalar device arguments through the per-frame cache: a
        static camera and unchanged size/intensity/num_draw reuse the
        SAME device buffers instead of re-uploading ~6 small scalars per
        frame (each a host->device transfer)."""
        cfg = self.config
        proj = camera.projection_matrix(cfg.aspect, cfg.fov_y, cfg.near,
                                        cfg.far)
        wvp = camera.world_view_projection(
            cfg.aspect, fov_y=cfg.fov_y, near=cfg.near, far=cfg.far
        )
        akey = (
            wvp.tobytes(), float(proj[0, 0]), float(proj[1, 1]),
            float(particle_size), float(particle_intensity), nd,
        )
        if akey != self._arg_key:
            self._arg_dev = (
                jnp.asarray(wvp),
                jnp.float32(abs(proj[0, 0])),
                jnp.float32(abs(proj[1, 1])),
                jnp.float32(particle_size),
                jnp.float32(particle_intensity),
                jnp.int32(nd),
            )
            self._arg_key = akey
        return self._arg_dev

    def _render_chunked(
        self, position, camera, particle_size, particle_intensity,
        num_draw, seg_q,
    ) -> FrameOutput:
        """Fold id-ordered particle chunks through the associative
        composite (see `_chunked_fold`); camera/scalar prep only —
        through the same `_device_args` cache as the single-pass path
        (the 4M/16.8M hot paths must not re-upload static scalars)."""
        cfg = self.config
        n = position.shape[1]
        _, cn = _chunk_width(n, self.chunk_size)
        self._last_sort_n = cn
        wvp, p00, p11, size, intensity, nd = self._device_args(
            camera, particle_size, particle_intensity,
            int(n if num_draw is None else num_draw),
        )
        return _chunked_fold(
            position, wvp, p00, p11, size, intensity, nd,
            width=cfg.width, height=cfg.height,
            seg_q=self.resolve_seg_q(cn, seg_q),
            dup_y=self.dup_y, dup_x=self.dup_x, near=cfg.near,
            blend=self.blend,
            composite=self.composite,
            chunk_size=self.chunk_size, frame_uint8=cfg.frame_uint8,
            starts_chunk=self.starts_chunk,
        )

    def raise_dup_for(self, out: FrameOutput) -> bool:
        """Grow the dup window to a frame's measured max sprite span.

        Reads the span scalars from the device — separate host reads,
        each a host round trip, so the hot path (`RenderEngine.present`)
        packs the fence + scalars into ONE device_get (`_present_probe`)
        and calls `raise_dup_values`.
        """
        return self.raise_dup_values(
            int(out.truncated), int(out.span_y), int(out.span_x)
        )

    def raise_dup_values(self, truncated: int, span_y: int,
                         span_x: int) -> bool:
        """`raise_dup_for` on already-pulled host scalars.

        Returns True if the window grew (the frame that produced them lost
        tiles; a re-render with the new window is lossless).

        The growth is bounded by `entry_budget`: sort entries = N x dup,
        so one near-camera sprite must not multiply a multi-million-
        particle pipeline (a single spanning sprite would raise dup for
        ALL entries). Within the
        budget the raise is lossless; beyond it the frame stays truncated
        and counted — small-N close-ups (the GUI size-10 case) always fit.
        """
        if truncated == 0:
            return False
        gh = self.config.height // TILE_H
        gw = self.config.width // TILE_W
        new_y = max(self.dup_y, min(int(span_y), gh))
        new_x = max(self.dup_x, min(int(span_x), gw))
        # Budget against the actual per-dispatch sort size: chunked frames
        # sort chunk_size*dup entries at a time, so dividing by the FULL
        # particle count would under-raise (dup=4 at 16.8M when each chunk
        # could afford 4x more).
        n = self._last_sort_n or self._last_n or 0
        if n:
            max_dup = max(4, self.entry_budget // n)
            while new_y * new_x > max_dup:
                # shrink the larger axis first; never below the current
                if new_y >= new_x and new_y > self.dup_y:
                    new_y -= 1
                elif new_x > self.dup_x:
                    new_x -= 1
                else:
                    break
        if (new_y, new_x) == (self.dup_y, self.dup_x):
            return False
        self.dup_y, self.dup_x = new_y, new_x
        return True

    def render(self, position, camera, particle_size, particle_intensity,
               num_draw=None) -> jax.Array:
        """One frame (exact at any depth), tracking the truncation metric.

        If the frame truncates sprite tiles (sprite bigger than the dup
        window) and `auto_raise_dup` is on, the window grows to the
        measured span and the frame re-renders — the result is lossless.
        """
        out = self.render_arrays(
            position, camera, particle_size, particle_intensity, num_draw
        )
        if self.auto_raise_dup and self.raise_dup_for(out):
            out = self.render_arrays(
                position, camera, particle_size, particle_intensity, num_draw
            )
        self.last_overflow = int(out.overflow)
        self.last_truncated = int(out.truncated)
        return out.frame

    def to_numpy_image(self, frame: jax.Array) -> np.ndarray:
        """[H, W, 3] float -> uint8 image."""
        return np.asarray(
            jnp.round(jnp.clip(frame, 0.0, 1.0) * 255.0).astype(jnp.uint8)
        )
