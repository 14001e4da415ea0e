"""Segmented sprite composite as a Pallas kernel for the Triton route.

The renderer's XLA formulation (`render/renderer.py`, the `lax.scan`
branch of `_render`) is a device loop over the Q sprite slots of every
virtual row, and each of its Q steps writes the four [V, px] carry
planes back to device memory. This kernel keeps them in registers:

- one program per block of `block_v` virtual rows; the colour and
  transmittance of the block's 8x16 tile pixels (px = 128) live in
  registers for the whole Q loop;
- each program loads its rows' live-slot bounds (`row_hi`) itself and
  loops only to their maximum. Slots at or past a row's bound carry
  alpha-scale 0, and blending alpha 0 is an exact identity, so stopping
  early equals the full loop bit for bit;
- device memory traffic is the sprite parameters read once and the
  result written once.

Parameter channels of `sp` [8, Q, V]: 0 cx, 1 cy, 2 1/(2hx), 3 1/(2hy),
4 r, 5 g, 6 b, 7 alpha-scale (zero for dead slots). Output [4, V, px]:
premultiplied r, g, b and transmittance per virtual row, ready for the
renderer's log-depth segment combine. Same arithmetic as the scan, so
results agree to FMA contraction; tests pin the equivalence.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# Launch parameters (sweep: chip_smoke.py composite phase).
DEFAULT_BLOCK_V = 16
DEFAULT_NUM_WARPS = 4


def _kernel(sp_ref, base_ref, hi_ref, out_ref, *, tile_w, px, blend):
    block_v = base_ref.shape[1]
    v0 = pl.program_id(0) * block_v
    pix = jax.lax.broadcasted_iota(jnp.int32, (1, px), 1)
    x_in = (pix % tile_w).astype(jnp.float32)
    y_in = (pix // tile_w).astype(jnp.float32)
    pxc = base_ref[0, :][:, None] + x_in + 0.5      # [VB, px]
    pyc = base_ref[1, :][:, None] + y_in + 0.5
    n_live = jnp.max(hi_ref[...])

    def body(q, carry):
        cr, cg, cb, tt = carry
        rows = pl.ds(v0, block_v)
        scx, scy, ihx, ihy, sr, sg, sb, sa = (
            sp_ref[c, q, rows][:, None] for c in range(8)
        )                                           # each [VB, 1]
        du = (pxc - scx) * ihx
        dv = (pyc - scy) * ihy
        dist = jnp.sqrt(du * du + dv * dv)
        alpha = jnp.clip(0.5 - dist, 0.0, 0.5) * sa  # [VB, px]
        if blend == "over":
            keep = 1.0 - alpha
            cr = cr * keep + jnp.clip(sr * alpha, 0.0, 1.0)
            cg = cg * keep + jnp.clip(sg * alpha, 0.0, 1.0)
            cb = cb * keep + jnp.clip(sb * alpha, 0.0, 1.0)
            tt = tt * keep
        else:  # additive
            cr = cr + jnp.clip(sr * alpha, 0.0, 1.0)
            cg = cg + jnp.clip(sg * alpha, 0.0, 1.0)
            cb = cb + jnp.clip(sb * alpha, 0.0, 1.0)
        return cr, cg, cb, tt

    zero = jnp.zeros((block_v, px), jnp.float32)
    one = jnp.ones((block_v, px), jnp.float32)
    cr, cg, cb, tt = jax.lax.fori_loop(0, n_live, body, (zero, zero, zero, one))
    out_ref[0, :, :] = cr
    out_ref[1, :, :] = cg
    out_ref[2, :, :] = cb
    out_ref[3, :, :] = tt


@functools.partial(
    jax.jit,
    static_argnames=(
        "tile_h", "tile_w", "blend", "block_v", "num_warps", "interpret",
    ),
)
def composite_rows_triton(
    sp: jax.Array,      # [8, Q, V] sprite params
    bases: jax.Array,   # [2, V] float32 tile base pixel coords (x, y)
    row_hi: jax.Array,  # [V] int32 exclusive bound of each row's live slots
    tile_h: int,
    tile_w: int,
    blend: str = "over",
    block_v: int = DEFAULT_BLOCK_V,
    num_warps: int = DEFAULT_NUM_WARPS,
    interpret: bool = False,
) -> jax.Array:
    """-> [4, V, px]: premultiplied rgb + transmittance per virtual row.

    Any V: the row axis is padded to whole blocks with dead rows
    (alpha-scale 0, bound 0). `interpret=True` runs the kernel in the
    Pallas interpreter (tests on the CPU)."""
    _, q_len, v = sp.shape
    px = tile_h * tile_w
    pad = (-v) % block_v
    hi = jnp.clip(row_hi.astype(jnp.int32), 0, q_len)
    if pad:
        sp = jnp.pad(sp, ((0, 0), (0, 0), (0, pad)))
        bases = jnp.pad(bases, ((0, 0), (0, pad)))
        hi = jnp.pad(hi, (0, pad))
    vp = v + pad
    # inside shard_map the result varies over the mesh axes its inputs do
    vma = jax.typeof(sp).vma | jax.typeof(bases).vma | jax.typeof(hi).vma

    kernel = functools.partial(_kernel, tile_w=tile_w, px=px, blend=blend)
    out = pl.pallas_call(
        kernel,
        grid=(vp // block_v,),
        in_specs=[
            pl.no_block_spec,
            pl.BlockSpec((2, block_v), lambda i: (0, i)),
            pl.BlockSpec((block_v,), lambda i: (i,)),
        ],
        out_specs=pl.BlockSpec((4, block_v, px), lambda i: (0, i, 0)),
        out_shape=jax.ShapeDtypeStruct((4, vp, px), jnp.float32, vma=vma),
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        cost_estimate=pl.CostEstimate(
            flops=int(vp) * int(q_len) * px * 14,
            bytes_accessed=int(vp) * (q_len * 32 + px * 16 + 12),
            transcendentals=int(vp) * int(q_len) * px,
        ),
        interpret=interpret,
        backend="triton",
        name="composite_rows",
    )(sp, bases, hi)
    return out[:, :v] if pad else out
