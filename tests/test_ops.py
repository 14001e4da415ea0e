"""Force kernels on the CPU: the central-well step against the oracle, and
the Triton all-pairs kernel through the Pallas interpreter against the
XLA formulation (the kernel itself compiles only for a GPU; chip_smoke.py
checks it there)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu import constants as C
from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models import integrator, oracle
from multi_adapter_particles_tpu.models.state import PAD_POSITION, ParticleState
from multi_adapter_particles_tpu.ops.allpairs import (
    all_pairs_accel_triton,
    make_accel_fn,
)


def state_from_oracle(n, seed=0):
    pos, vel = oracle.initialize_particles(n, variant="scalar", seed=seed)
    return ParticleState.from_aos(pos, vel), pos, vel


def triton(position, **kw):
    kw.setdefault("mass", C.PARTICLE_MASS)
    kw.setdefault("softening_squared", C.SOFTENING_SQUARED)
    return np.asarray(all_pairs_accel_triton(position, interpret=True, **kw))


class TestCentralWellKernel:
    """The central well is plain XLA on every backend: one fused step."""

    def test_matches_oracle(self):
        self._check_oracle(256)

    def test_matches_oracle_unaligned(self):
        self._check_oracle(200)  # padded to 256 with parked particles

    def _check_oracle(self, n):
        st, pos, vel = state_from_oracle(n)
        step = integrator.make_step(SimConfig(num_particles=n), donate=False)
        out = step(st)
        opos, ovel = oracle.central_well_step(pos, vel)
        npos, nvel = out.to_aos(n)
        np.testing.assert_allclose(npos, opos, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(nvel, ovel, rtol=2e-5, atol=2e-5)

    def test_multi_tile_grid(self):
        """Several steps in a row stay on the oracle trajectory."""
        n = 512
        st, pos, vel = state_from_oracle(n, seed=3)
        step = integrator.make_step(SimConfig(num_particles=n), donate=False)
        for _ in range(4):
            st = step(st)
            pos, vel = oracle.central_well_step(pos, vel)
        np.testing.assert_allclose(st.to_aos(n)[0], pos, rtol=1e-4,
                                   atol=1e-4)


class TestAllPairsKernel:
    def test_matches_xla_blocked(self):
        self._check_xla(256, 64, 32)

    @pytest.mark.parametrize("n,block_i,block_j", [
        (100, 64, 32),     # neither side a block multiple
        (300, 128, 64),
        (130, 32, 128),    # one source block wider than all of n
    ])
    def test_matches_xla_blocked_shapes(self, n, block_i, block_j):
        self._check_xla(n, block_i, block_j)

    def _check_xla(self, n, block_i, block_j):
        st, _, _ = state_from_oracle(n, seed=1)
        pos = st.position[:, :n]
        acc_p = triton(pos, block_i=block_i, block_j=block_j)
        acc_x = np.asarray(
            integrator.all_pairs_accel(
                pos, C.PARTICLE_MASS, C.SOFTENING_SQUARED
            )
        )
        assert acc_p.shape == (4, n)
        scale = np.abs(acc_x).max()
        assert np.abs(acc_p[:3] - acc_x).max() < 1e-5 * max(scale, 1.0)
        # |a| channel
        np.testing.assert_allclose(
            acc_p[3], np.linalg.norm(acc_p[:3], axis=0), rtol=1e-5, atol=1e-6
        )

    def test_matches_oracle_step(self):
        n = 128
        st, pos, vel = state_from_oracle(n, seed=2)
        accel_fn = make_accel_fn(
            C.PARTICLE_MASS, C.SOFTENING_SQUARED, interpret=True
        )
        step = integrator.make_step(
            SimConfig(num_particles=n, force_model="all_pairs",
                      interaction_scale=1.0),  # accel_fn is unscaled
            accel_fn=accel_fn,
            donate=False,
        )
        out = step(st)
        opos, ovel = oracle.all_pairs_step(pos, vel)
        nvel = out.to_aos(n)[1]
        np.testing.assert_allclose(nvel, ovel, rtol=1e-3, atol=1e-4)

    def test_interaction_scale(self):
        n = 128
        st, _, _ = state_from_oracle(n, seed=4)
        a1 = triton(st.position, interaction_scale=1.0)
        a2 = triton(st.position, interaction_scale=2.0)
        np.testing.assert_allclose(a2[:3], a1[:3] * 2.0, rtol=1e-5)

    def test_parked_padding_needs_no_mask(self):
        """A padded state (100 live of 128, the tail parked at 1e9): the
        kernel's unmasked sum equals the XLA path's masked one on every
        live particle, and parked targets stay finite."""
        n = 100
        st, _, _ = state_from_oracle(n, seed=5)
        assert st.padded_count == 128
        assert np.all(np.asarray(st.position)[:3, n:] == PAD_POSITION)
        mask = (jnp.arange(128) < n).astype(jnp.float32)
        acc_x = np.asarray(integrator.all_pairs_accel(
            st.position, C.PARTICLE_MASS, C.SOFTENING_SQUARED, mask=mask,
        ))
        acc_p = triton(st.position)
        assert np.isfinite(acc_p).all()
        scale = np.abs(acc_x[:, :n]).max()
        assert np.abs(acc_p[:3, :n] - acc_x[:, :n]).max() < 1e-5 * scale

    def test_split_sources(self):
        """The sharded schedules' split form: targets against a separate
        source set of a different width."""
        rng = np.random.default_rng(9)
        tgt = jnp.asarray(rng.uniform(-300, 300, (4, 96)).astype(np.float32))
        src = jnp.asarray(rng.uniform(-300, 300, (4, 200)).astype(np.float32))
        acc_p = triton(tgt, sources=src)
        acc_x = np.asarray(integrator.all_pairs_accel(
            tgt, C.PARTICLE_MASS, C.SOFTENING_SQUARED, sources=src,
        ))
        assert acc_p.shape == (4, 96)
        np.testing.assert_allclose(acc_p[:3], acc_x, rtol=1e-5,
                                   atol=1e-5 * np.abs(acc_x).max())


class TestOddTileCount:
    def test_allpairs_odd_j_tiles(self):
        """An odd number of source blocks (768 / 256 = 3)."""
        n = 768
        pos = jax.random.uniform(
            jax.random.PRNGKey(3), (4, n), jnp.float32, -400.0, 400.0
        ).at[3].set(0.0)
        a = triton(pos, mass=70000.0, softening_squared=25.0,
                   block_i=256, block_j=256)
        b = integrator.all_pairs_accel(
            pos, mass=70000.0, softening_squared=25.0
        )
        np.testing.assert_allclose(
            np.asarray(a)[:3], np.asarray(b), rtol=1e-4, atol=1e-2
        )
