"""Lane-packed random row gather.

Gathering [N] random rows from a narrow [R, W] table (W < 128) issues
one row per index however few elements the row holds. Packing 128//W
rows into one 128-wide line and selecting the sub-row afterwards makes
each issue move a whole line; it reads more bytes per row, and pays off
where the gather is issue-bound rather than bandwidth-bound. Whether it
still wins over the plain gather on the GPU is open (ROADMAP D5).

`gather_rows` packs P = 128//W table rows per 128-lane line, gathers
line idx//P, and selects sub-row idx%P with a compare/select chain
(selects, not one-hot multiplies, so non-finite payloads in unselected
rows cannot poison the result). Bitwise identical to `table[idx]`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _max_line_bytes() -> int:
    """Cap on the materialized [N, 128] gather: 1/8 of device memory."""
    from multi_adapter_particles_tpu.ops.dispatch import memory_limit_bytes

    return memory_limit_bytes() // 8


def gather_rows(table: jax.Array, idx: jax.Array,
                packed_w: int | None = None) -> jax.Array:
    """table [R, W], idx [N] int -> [N, W]; bitwise == table[idx].

    Packs narrow rows into 128-lane lines when profitable (W < 128 and
    W | 128); otherwise falls back to the plain gather. Very large N
    chunk through `lax.map` so the widened [N, 128] intermediate stays
    bounded (at 16.8M rows it would otherwise be 8.6 GB).

    `packed_w=w`: the table is ALREADY lane-packed — [R/P, P*w] lines of
    P = 128//w logical rows each (e.g. pm._pack_corner_rows output,
    which never materializes the 4x-lane-padded [R, w] form). idx still
    addresses logical rows."""
    if packed_w is not None:
        w = packed_w
        p = 128 // w
        if table.shape[1] != p * w:
            raise ValueError(
                f"packed table width {table.shape[1]} != {p}*{w}"
            )
        packed = table
    else:
        r, w = table.shape
        if w >= 128 or 128 % w != 0:
            return table[idx]
        p = 128 // w
        rp = -(-r // p)
        pad = rp * p - r
        if pad:
            table = jnp.concatenate(
                [table, jnp.zeros((pad, w), table.dtype)], axis=0
            )
        packed = table.reshape(rp, p * w)

    def _do(ci):
        rows = packed[ci // p].reshape(ci.shape[0], p, w)  # ONE wide gather
        sub = (ci % p).astype(jnp.int32)[:, None]
        out = rows[:, 0]
        for c in range(1, p):
            out = jnp.where(sub == c, rows[:, c], out)
        return out

    n = idx.shape[0]
    line_bytes = 128 * table.dtype.itemsize
    max_bytes = _max_line_bytes()
    if n * line_bytes <= max_bytes:
        return _do(idx)
    chunk = max_bytes // line_bytes
    k = -(-n // chunk)
    idx_pad = jnp.concatenate(
        [idx, jnp.zeros(k * chunk - n, idx.dtype)]
    ) if k * chunk != n else idx
    out = jax.lax.map(_do, idx_pad.reshape(k, chunk))
    return out.reshape(k * chunk, w)[:n]
