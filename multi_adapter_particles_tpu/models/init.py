"""Device-side particle initialization.

The reference initializes particles on the CPU with a parallel_for over three
selectable RNG tiers and uploads them via staging buffers
(`Compute.cpp:667-923`). The on-device equivalents are:

- `initialize_particles_device`: the same rejection-accumulation algorithm
  (`Compute.cpp:690-695`) run entirely on device — one fold-in PRNG stream per
  particle (`jax.random.fold_in`), the accumulation loop as a vmapped
  `lax.while_loop`. No host->device bulk upload at all: the staging-buffer
  dance disappears because the data is born on the accelerator.
- `initialize_particles_host`: NumPy oracle tiers ('orig'/'scalar'/'simd',
  see `models/oracle.py`) or the native C++ engine (`native/`), then
  `ParticleState.from_aos` — the analog of the upload path, used for parity
  testing and bit-exact reproduction of the reference clusters.

Both produce two counter-orbiting clusters at (+/-0.75*spread, 0, 0)
(`Compute.cpp:832-844`).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu import constants as C
from multi_adapter_particles_tpu.models.state import (
    PAD_POSITION,
    ParticleState,
    padded_count,
)

# Bound on rejection-loop iterations. E[|delta|^2] grows by ~1 per draw, the
# threshold is 10, so ~11 expected iterations; 256 is a safe static ceiling
# for the vmapped while_loop (probability of hitting it is negligible and the
# loop exits early when every lane is done).
_MAX_ACCUM_ITERS = 256


def _cluster_delta(key: jax.Array) -> jax.Array:
    """The rejection-accumulation direction draw (`Compute.cpp:690-695`):
    sum uniform(-1,1)^3 draws until |sum|^2 >= 10, then the caller normalizes.
    Returns delta [3]."""

    def draw(k):
        k, sub = jax.random.split(k)
        return k, jax.random.uniform(
            sub, (3,), minval=-1.0, maxval=1.0, dtype=jnp.float32
        )

    key, delta = draw(key)

    def cond(carry):
        _, d, it = carry
        return jnp.logical_and(
            jnp.sum(d * d) < jnp.float32(C.INIT_DELTA_LENGTH_SQ_MIN),
            it < _MAX_ACCUM_ITERS,
        )

    def body(carry):
        k, d, it = carry
        k, step = draw(k)
        return k, d + step, it + 1

    _, delta, _ = jax.lax.while_loop(cond, body, (key, delta, 0))
    return delta


def _finalize(delta: jax.Array, center: jax.Array, speed: float, spread: float):
    """Position + perpendicular-ish velocity (`Compute.cpp:697-708`)."""
    delta = delta * jax.lax.rsqrt(jnp.sum(delta * delta))
    pos = center + delta * jnp.float32(spread)
    direction = pos * jax.lax.rsqrt(jnp.sum(pos * pos))
    perp = jnp.array([1.0, 1.0, 1.0], dtype=jnp.float32) - direction
    perp = perp * jax.lax.rsqrt(jnp.sum(perp * perp))
    vel = jnp.cross(direction, perp) * jnp.float32(speed)
    return pos, vel


@functools.partial(
    jax.jit, static_argnames=("num_particles", "spread", "initial_speed")
)
def _init_device(
    key: jax.Array,
    num_particles: int,
    spread: float,
    initial_speed: float,
) -> Tuple[jax.Array, jax.Array]:
    np_pad = padded_count(num_particles)
    half = num_particles // 2
    center_spread = spread * 0.75
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(np_pad))
    deltas = jax.vmap(_cluster_delta)(keys)  # [Np, 3]

    centers = jnp.where(
        (jnp.arange(np_pad) < half)[:, None],
        jnp.array([center_spread, 0.0, 0.0], dtype=jnp.float32),
        jnp.array([-center_spread, 0.0, 0.0], dtype=jnp.float32),
    )
    pos3, vel3 = jax.vmap(
        lambda d, c: _finalize(d, c, initial_speed, spread)
    )(deltas, centers)

    live = (jnp.arange(np_pad) < num_particles)[:, None]
    pos3 = jnp.where(live, pos3, jnp.float32(PAD_POSITION))
    vel3 = jnp.where(live, vel3, 0.0)

    position = jnp.concatenate(
        [pos3.T, jnp.zeros((1, np_pad), dtype=jnp.float32)], axis=0
    )
    return position, vel3.T


def initialize_particles_device(
    num_particles: int,
    seed: int = 0,
    spread: float = C.PARTICLE_SPREAD,
    initial_speed: float = C.INITIAL_PARTICLE_SPEED,
) -> ParticleState:
    """Two clusters, fully on-device. pos.w starts 0 (`Compute.cpp:825-829`)."""
    key = jax.random.PRNGKey(seed)
    position, velocity = _init_device(
        key, num_particles=num_particles, spread=spread, initial_speed=initial_speed
    )
    return ParticleState(position, velocity)


def initialize_particles_host(
    num_particles: int,
    variant: str = "orig",
    seed: int = 0,
    spread: float = C.PARTICLE_SPREAD,
    initial_speed: float = C.INITIAL_PARTICLE_SPEED,
    use_native: Optional[bool] = None,
) -> ParticleState:
    """Host-side init through an oracle tier (or the native C++ engine when
    available), then upload — the staging-buffer path analog."""
    # Auto mode (None) routes only the LCG tiers to native: those are
    # bit-identical to the oracle; native 'orig' (std::mt19937) is
    # deterministic but draws a different stream than NumPy's MT19937.
    if use_native or (use_native is None and variant in ("scalar", "simd")):
        try:
            from multi_adapter_particles_tpu.native import fastinit

            if fastinit.available():
                pos, vel = fastinit.initialize_particles(
                    num_particles,
                    variant=variant,
                    seed=seed,
                    spread=spread,
                    initial_speed=initial_speed,
                )
                return ParticleState.from_aos(pos, vel)
        except ImportError:
            pass
        if use_native:
            raise RuntimeError("native fastinit requested but not available")
    from multi_adapter_particles_tpu.models import oracle

    pos, vel = oracle.initialize_particles(
        num_particles,
        variant=variant,
        seed=seed,
        spread=spread,
        initial_speed=initial_speed,
    )
    return ParticleState.from_aos(pos, vel)
