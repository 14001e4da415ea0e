"""Particle state pytree.

The reference keeps AoS buffers: position float4 (w = |accel| for coloring,
`nBodyGravityCS.hlsl:107`, `Render.h:85-88`) and velocity float3
(`Compute.h:66-69`), double-buffered as 2+2 ping-pong UAVs
(`Compute.h:80,106-108`).

Redesign:
- **SoA planes** `position[4, N]`, `velocity[3, N]`: each coordinate is a
  contiguous row, so elementwise physics reads coalesced streams and the
  blocked all-pairs kernel loads whole coordinate tiles.
- **No explicit ping-pong**: the double buffer becomes functional state +
  `jax.jit` buffer donation; XLA aliases input/output storage, which is the
  descriptor-base-sliding trick (`Compute.cpp:52-62,1030-1035`) done by the
  compiler.
- `N` is padded up to a multiple of 128 (`constants.LANE`); padding particles
  are parked far away with zero velocity so they never affect rendering and,
  in the all-pairs model, are masked out of the interaction sum.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multi_adapter_particles_tpu import constants as C

# Padding particles park here: far outside the far plane (5000,
# Render.cpp:776) and the simulation region (spread 400).
PAD_POSITION = 1.0e9


@jax.tree_util.register_pytree_node_class
class ParticleState:
    """SoA particle state: position[4, Np] (x, y, z, |accel|), velocity[3, Np].

    `Np` is the padded (lane-aligned) count. The logical count is not part of
    the pytree (it is static config); use `make_mask` when it matters.
    """

    __slots__ = ("position", "velocity")

    def __init__(self, position: jax.Array, velocity: jax.Array):
        self.position = position
        self.velocity = velocity

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self.position, self.velocity), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        return cls(*children)

    # -- introspection --------------------------------------------------------
    @property
    def padded_count(self) -> int:
        return self.position.shape[-1]

    @property
    def dtype(self):
        return self.position.dtype

    def __repr__(self):
        return (
            f"ParticleState(padded_count={self.padded_count}, "
            f"dtype={self.position.dtype})"
        )

    # -- conversions ----------------------------------------------------------
    @classmethod
    def from_aos(
        cls, positions: np.ndarray, velocities: np.ndarray, pad_to_lane: bool = True
    ) -> "ParticleState":
        """Build from reference-layout arrays: positions [N, 4], velocities [N, 3]."""
        positions = np.asarray(positions, dtype=np.float32)
        velocities = np.asarray(velocities, dtype=np.float32)
        if positions.ndim != 2 or positions.shape[1] != 4:
            raise ValueError(f"positions must be [N, 4], got {positions.shape}")
        if velocities.shape != (positions.shape[0], 3):
            raise ValueError(f"velocities must be [N, 3], got {velocities.shape}")
        n = positions.shape[0]
        np_pad = padded_count(n) if pad_to_lane else n
        pos = np.full((4, np_pad), PAD_POSITION, dtype=np.float32)
        pos[3, :] = 0.0
        vel = np.zeros((3, np_pad), dtype=np.float32)
        pos[:, :n] = positions.T
        vel[:, :n] = velocities.T
        return cls(jnp.asarray(pos), jnp.asarray(vel))

    def to_aos(self, num_particles: int) -> Tuple[np.ndarray, np.ndarray]:
        """Back to reference layout ([N, 4], [N, 3]) for oracles and IO."""
        pos = np.asarray(self.position)[:, :num_particles].T
        vel = np.asarray(self.velocity)[:, :num_particles].T
        return np.ascontiguousarray(pos), np.ascontiguousarray(vel)

    def make_mask(self, num_particles: int) -> jax.Array:
        """[Np] float32 mask: 1 for real particles, 0 for padding."""
        idx = jnp.arange(self.padded_count)
        return (idx < num_particles).astype(self.position.dtype)


def padded_count(n: int, lane: int = C.LANE) -> int:
    """Round a particle count up to the lane multiple (`constants.LANE`)."""
    return -(-n // lane) * lane


def zeros(num_particles: int, dtype=jnp.float32) -> ParticleState:
    """All-zero state (padding parked), mostly for shape probing and tests."""
    np_pad = padded_count(num_particles)
    pos = np.full((4, np_pad), PAD_POSITION, dtype=np.float32)
    pos[3, :] = 0.0
    pos[:3, :num_particles] = 0.0
    vel = np.zeros((3, np_pad), dtype=np.float32)
    return ParticleState(
        jnp.asarray(pos, dtype=dtype), jnp.asarray(vel, dtype=dtype)
    )
