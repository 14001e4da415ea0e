"""Device integrator vs. NumPy oracle — the core parity tests
(survey SS4: 'unit tests for the integrator vs. a NumPy oracle')."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu import constants as C
from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models import integrator, oracle
from multi_adapter_particles_tpu.models.state import ParticleState, padded_count


import functools


@functools.lru_cache(maxsize=None)
def _cached_init(n, seed, variant):
    pos, vel = oracle.initialize_particles(n, variant=variant, seed=seed)
    pos.setflags(write=False)
    vel.setflags(write=False)
    return pos, vel


def make_state(n=256, seed=0, variant="scalar"):
    pos, vel = _cached_init(n, seed, variant)
    return ParticleState.from_aos(pos, vel), pos.copy(), vel.copy()


class TestCentralWell:
    def test_single_step_matches_oracle(self):
        n = 512
        state, pos, vel = make_state(n)
        step = integrator.make_step(SimConfig(num_particles=n), donate=False)
        new_state = step(state)
        opos, ovel = oracle.central_well_step(pos, vel)
        npos, nvel = new_state.to_aos(n)
        np.testing.assert_allclose(npos, opos, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(nvel, ovel, rtol=2e-5, atol=2e-5)

    def test_trajectory_100_steps(self):
        n = 128
        state, pos, vel = make_state(n, seed=3)
        step = integrator.make_step(SimConfig(num_particles=n))
        for _ in range(100):
            state = step(state)
            pos, vel = oracle.central_well_step(pos, vel)
        npos, nvel = state.to_aos(n)
        # fp32 divergence accumulates; positions stay within ~1e-2 of a
        # few-hundred-unit trajectory over 100 steps
        np.testing.assert_allclose(npos[:, :3], pos[:, :3], rtol=1e-3, atol=5e-2)
        np.testing.assert_allclose(nvel, vel, rtol=1e-3, atol=5e-2)

    def test_padding_stays_parked(self):
        n = 100  # not a multiple of 128 -> 28 padding lanes
        state, _, _ = make_state(n)
        assert state.padded_count == padded_count(n) == 128
        step = integrator.make_step(SimConfig(num_particles=n), donate=False)
        out = step(state)
        pad_pos = np.asarray(out.position)[:3, n:]
        # parked far away and (to fp32 resolution) immobile
        assert np.all(np.abs(pad_pos) > 1e8)

    def test_accel_magnitude_in_w(self):
        n = 128
        state, pos, vel = make_state(n, seed=7)
        step = integrator.make_step(SimConfig(num_particles=n), donate=False)
        out = step(state)
        npos, _ = out.to_aos(n)
        r = pos[:, :3].astype(np.float64)
        d2 = (r * r).sum(1) + C.SOFTENING_SQUARED
        amag = np.linalg.norm(r * (-C.PARTICLE_MASS / d2**1.5)[:, None], axis=1)
        np.testing.assert_allclose(npos[:, 3], amag, rtol=1e-4)

    def test_num_sim_freezes_tail(self):
        """Particles >= num_sim must keep their exact previous state
        (Compute.cpp:1041: short dispatch leaves the rest of the buffer)."""
        n = 256
        state, _, _ = make_state(n, seed=1)
        step = integrator.make_step(SimConfig(num_particles=n), donate=False)
        out = step(state, 64)
        pos_in = np.asarray(state.position)
        pos_out = np.asarray(out.position)
        vel_in = np.asarray(state.velocity)
        vel_out = np.asarray(out.velocity)
        np.testing.assert_array_equal(pos_out[:, 64:], pos_in[:, 64:])
        np.testing.assert_array_equal(vel_out[:, 64:], vel_in[:, 64:])
        assert not np.array_equal(pos_out[:, :64], pos_in[:, :64])

    def test_donation_ping_pong(self):
        """Donated step must keep producing correct results across many calls
        (the descriptor-base ping-pong analog, Compute.cpp:52-62)."""
        n = 128
        state, pos, vel = make_state(n, seed=4)
        step = integrator.make_step(SimConfig(num_particles=n), donate=True)
        for _ in range(10):
            state = step(state)
            pos, vel = oracle.central_well_step(pos, vel)
        npos, _ = state.to_aos(n)
        np.testing.assert_allclose(npos[:, :3], pos[:, :3], rtol=1e-4, atol=1e-3)


class TestAllPairs:
    @pytest.mark.parametrize("n", [64, 256])
    def test_single_step_matches_oracle(self, n):
        state, pos, vel = make_state(n, seed=2)
        cfg = SimConfig(num_particles=n, force_model="all_pairs",
                        interaction_scale=1.0)  # oracle parity at scale 1
        step = integrator.make_step(cfg, donate=False)
        out = step(state)
        opos, ovel = oracle.all_pairs_step(pos, vel)
        npos, nvel = out.to_aos(n)
        np.testing.assert_allclose(nvel, ovel, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(npos[:, :3], opos[:, :3], rtol=1e-4, atol=1e-4)

    def test_padding_does_not_pollute(self):
        """Padding particles parked at 1e9 must contribute zero force."""
        n = 100  # 28 padding lanes
        state, pos, vel = make_state(n, seed=8)
        cfg = SimConfig(num_particles=n, force_model="all_pairs",
                        interaction_scale=1.0)  # oracle parity at scale 1
        step = integrator.make_step(cfg, donate=False)
        out = step(state)
        opos, ovel = oracle.all_pairs_step(pos, vel)
        nvel = out.to_aos(n)[1]
        np.testing.assert_allclose(nvel, ovel, rtol=1e-3, atol=1e-4)

    def test_momentum_conserved(self):
        n = 128
        state, pos, vel = make_state(n, seed=5)
        cfg = SimConfig(num_particles=n, force_model="all_pairs")
        step = integrator.make_step(cfg)
        p0 = np.asarray(state.velocity)[:, :n].sum(axis=1)
        for _ in range(20):
            state = step(state)
        p1 = np.asarray(state.velocity)[:, :n].sum(axis=1)
        # pairwise forces are antisymmetric -> total momentum is conserved
        np.testing.assert_allclose(p0, p1, atol=2e-2)

    def test_tiled_equals_untiled(self):
        n = 512
        state, _, _ = make_state(n, seed=6)
        a1 = integrator.all_pairs_accel(
            state.position, C.PARTICLE_MASS, C.SOFTENING_SQUARED, j_tile=128
        )
        a2 = integrator.all_pairs_accel(
            state.position, C.PARTICLE_MASS, C.SOFTENING_SQUARED, j_tile=512
        )
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-5, atol=1e-5)


class TestInteractionScaleDefault:
    """interaction_scale=None resolves per force model (VERDICT r2 #6):
    1.0 for the central well (the reference's baked per-well constants,
    `Compute.cpp:543-546`) and 1/N for the self-gravity models, so a bare
    `-force pm_grid` run keeps the total attracting mass at the
    central-well value instead of scaling it by the particle count."""

    def test_central_well_default_is_one(self):
        assert SimConfig(num_particles=1000).interaction_scale == 1.0

    @pytest.mark.parametrize("fm", ["all_pairs", "pm_grid", "p3m"])
    def test_self_gravity_default_is_inverse_n(self, fm):
        cfg = SimConfig(num_particles=4096, force_model=fm)
        assert cfg.interaction_scale == pytest.approx(1.0 / 4096)

    def test_explicit_override_wins(self):
        cfg = SimConfig(
            num_particles=4096, force_model="pm_grid", interaction_scale=0.5
        )
        assert cfg.interaction_scale == 0.5

    def test_auto_scale_trajectory_is_sane(self):
        """A bare self-gravity config produces bounded motion over a few
        steps (the 1e6x foot-gun produced immediate blow-up)."""
        n = 256
        state, pos, _ = make_state(n, seed=9)
        r0 = np.linalg.norm(pos[:, :3], axis=1).max()
        step = integrator.make_step(
            SimConfig(num_particles=n, force_model="all_pairs"), donate=False
        )
        for _ in range(10):
            state = step(state)
        npos = state.to_aos(n)[0]
        assert np.isfinite(npos).all()
        r = np.linalg.norm(npos[:, :3], axis=1).max()
        assert r < 4.0 * r0  # scale 1.0 ejects to ~1e3 x r0 in 10 steps

    def test_p3m_cutoff_below_minimum_rejected(self):
        with pytest.raises(ValueError, match="cutoff"):
            SimConfig(
                num_particles=256, force_model="p3m", p3m_cutoff_cells=2.0
            )
        from multi_adapter_particles_tpu.ops.p3m import validate_cutoff_cells

        with pytest.raises(ValueError, match="minimum usable"):
            validate_cutoff_cells(2.5)
        validate_cutoff_cells(2.7)  # just above ~2.598: fine


class TestRunAccelContract:
    def test_make_accel_fn_for_matches_engine_kernel(self):
        for impl in ("xla", "triton-interpret"):
            self._check_contract(impl)

    def _check_contract(self, impl):
        """make_accel_fn_for's all_pairs branch is the implementation the
        engines run (ComputeEngine passes it the device's choice) — "the
        run's own accel" contract the diagnostics half-kick reuse relies
        on. Each named implementation is reproduced bitwise, and the two
        agree to f32 accumulation-order tolerance."""
        from multi_adapter_particles_tpu.models import init as pinit
        from multi_adapter_particles_tpu.ops import allpairs
        from multi_adapter_particles_tpu.runtime.compute_engine import (
            ComputeEngine,
        )

        n = 1000  # padded to 1024: the parked tail rides along
        state = pinit.initialize_particles_device(n, seed=3)
        cfg = SimConfig(num_particles=n, force_model="all_pairs")
        got = np.asarray(
            integrator.make_accel_fn_for(cfg, impl)(state.position)
        )
        if impl == "xla":
            m = (np.arange(state.padded_count) < n).astype(np.float32)
            want = np.asarray(integrator.all_pairs_accel(
                state.position, mass=cfg.mass,
                softening_squared=cfg.softening_squared,
                interaction_scale=cfg.interaction_scale, mask=m,
            ))
        else:
            want = np.asarray(allpairs.make_accel_fn(
                mass=cfg.mass, softening_squared=cfg.softening_squared,
                interaction_scale=cfg.interaction_scale, interpret=True,
            )(state.position))
        np.testing.assert_array_equal(got, want)
        xla = np.asarray(
            integrator.make_accel_fn_for(cfg, "xla")(state.position)
        )
        scale = np.abs(xla[:, :n]).max()
        assert np.abs(got[:, :n] - xla[:, :n]).max() < 1e-5 * scale
        eng = ComputeEngine(cfg, jax.devices()[0], seed=3,
                            all_pairs_impl=impl, donate=False)
        assert eng.all_pairs_impl == impl
