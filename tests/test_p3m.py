"""P³M force model vs the exact all-pairs law.

The headline promise: unlike pure PM (a few % RMS, wrong below ~2 cells),
P³M converges to the exact softened pair force at EVERY separation —
including deep inside a mesh cell — because the short-range pairwise
correction cancels the smooth mesh kernel exactly beyond its own switch.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models import init as pinit, integrator
from multi_adapter_particles_tpu.ops import p3m, pm

MASS = 70000.0
EPS2 = 25.0


def aos(pos3):
    p = np.zeros((4, pos3.shape[0]), np.float32)
    p[:3] = pos3.T
    return jnp.asarray(p)


def exact(pos3):
    return np.asarray(
        integrator.all_pairs_accel(aos(pos3), mass=MASS,
                                   softening_squared=EPS2)
    )


class TestShortRangeFactor:
    def test_negligible_beyond_cutoff(self):
        """|s_short| has decayed to a few 1e-4 of the exact factor at the
        cutoff r_c = 4.5 sigma — the truncation the 27-cell neighborhood
        implies. Two tail components at r_c: the Gaussian remainder
        (~1.4e-4) and the Plummer-vs-pure mismatch (1.5 eps²/r_c², ~2e-4
        at the default r_c = 432). The parked-slot contribution
        (d ~ 1.7e9) is a vanishing force."""
        r_c = 432.0  # the default: 6.75 cells of 64 units
        sigma = r_c * p3m._SIGMA_PER_CUTOFF
        r = np.asarray([432.0, 500.0, 900.0], np.float32)
        d2 = jnp.asarray(r * r)
        s = np.abs(np.asarray(p3m._short_factor(d2, EPS2, sigma)))
        s_exact = (r * r + EPS2) ** -1.5
        assert np.all(s <= 4e-4 * s_exact)
        park = np.float32(3e18)  # d² between a live and a parked 1e9 slot
        s_park = np.asarray(
            p3m._short_factor(jnp.asarray([park]), EPS2, sigma)
        )
        assert abs(s_park[0]) * 1.8e9 < 1e-12  # |force| = |s| * |r_vec|

    def test_split_identity(self):
        """s_short + g_long == s_exact to fp precision at every r > 0
        (the Ewald split is exact by construction, not approximate; at
        r = 0 the guarded g_long returns 0, which only ever multiplies
        r_vec = 0)."""
        r_c = 96.0
        sigma = r_c * p3m._SIGMA_PER_CUTOFF
        r = np.asarray([0.5, 2.0, 20.0, 50.0, 95.0], np.float32)
        d2 = jnp.asarray(r * r)
        s_short = np.asarray(p3m._short_factor(d2, EPS2, sigma))
        s_long = np.asarray(p3m._g_long(d2, sigma))
        s_exact = (np.asarray(d2) + EPS2) ** -1.5
        np.testing.assert_allclose(s_short + s_long, s_exact, rtol=1e-5)
        # s_short stays finite (and exact) at r = 0
        s0 = np.asarray(p3m._short_factor(jnp.asarray([0.0]), EPS2, sigma))
        assert s0[0] == pytest.approx(EPS2**-1.5, rel=1e-6)


@pytest.mark.slow
class TestTwoBody:
    @pytest.mark.parametrize("r", [3.0, 10.0, 40.0, 100.0, 160.0, 600.0])
    def test_all_separations(self, r):
        """Two bodies at separations from sub-softening to many cells,
        placed at the WORST-CASE sub-cell offset (the box center sits
        between nodes): P³M within 4% of exact everywhere — pure PM is
        order-of-magnitude wrong below ~2 cells = 128 units at this G.
        (Averaged over sub-cell positions the error is <1%; see the
        tightening test below for the accuracy/cutoff knob.)"""
        g, box = 32, 2048.0
        pos3 = np.array([[-r / 2, 0, 0], [r / 2, 0, 0]], np.float32)
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=g, box=box, g_const=MASS,
            softening_squared=EPS2,
        )
        acc = np.asarray(acc)
        assert int(overflow) == 0
        want = MASS / (r * r + EPS2) ** 1.5 * r
        assert acc[0, 0] == pytest.approx(want, rel=0.04), f"r={r}"
        assert acc[0, 1] == pytest.approx(-want, rel=0.04)

    def test_tiny_near_grid_covers_cutoff(self):
        """When r_c > box/3 the near grid collapses to gn = 1 (the whole
        box is one cell, every pair is in-neighborhood). A gn floor above
        box//r_c would shrink cells BELOW the cutoff and silently drop
        pairs — regression for that clamp."""
        g, box = 8, 2048.0   # r_c = 6.75 * 256 = 1728 > box/3
        r = 500.0
        pos3 = np.array([[-r / 2, 0, 0], [r / 2, 0, 0]], np.float32)
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=g, box=box, g_const=MASS,
            softening_squared=EPS2,
        )
        assert int(overflow) == 0
        want = MASS / (r * r + EPS2) ** 1.5 * r
        assert np.asarray(acc)[0, 0] == pytest.approx(want, rel=0.04)

    @pytest.mark.parametrize("r", [10.0, 130.0, 300.0, 432.0])
    def test_higher_cutoff_tightens(self, r):
        """cutoff_cells = 9 (sigma_eff = 2h) halves the worst-case error:
        within 2% at every separation — the accuracy/cost knob works."""
        g, box = 32, 2048.0
        pos3 = np.array([[-r / 2, 0, 0], [r / 2, 0, 0]], np.float32)
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=g, box=box, g_const=MASS,
            softening_squared=EPS2, cutoff_cells=9.0,
        )
        assert int(overflow) == 0
        want = MASS / (r * r + EPS2) ** 1.5 * r
        assert np.asarray(acc)[0, 0] == pytest.approx(want, rel=0.02)

    def test_close_pair_beats_pm(self):
        """At r = half a cell, pure PM is order-of-magnitude wrong while
        P³M stays within 2%."""
        g, box = 32, 2048.0
        r = 32.0  # cell = 64
        pos3 = np.array([[-r / 2, 0, 0], [r / 2, 0, 0]], np.float32)
        want = MASS / (r * r + EPS2) ** 1.5 * r
        a_p3m = np.asarray(p3m.p3m_accel(
            aos(pos3), grid=g, box=box, g_const=MASS,
            softening_squared=EPS2))
        a_pm = np.asarray(pm.pm_accel(
            aos(pos3), grid=g, box=box, g_const=MASS,
            softening_squared=EPS2))
        err_p3m = abs(a_p3m[0, 0] - want) / want
        err_pm = abs(a_pm[0, 0] - want) / want
        assert err_p3m < 0.02
        assert err_pm > 5 * err_p3m  # PM visibly worse here


@pytest.mark.slow
class TestCluster:
    def test_matches_all_pairs_rms(self):
        """Random blob: P³M within 1% RMS of the exact sum (pure PM is
        ~5-8% on the same configuration — see test_pm.py)."""
        rng = np.random.default_rng(11)
        n = 512
        pos3 = rng.normal(0, 300, (n, 3)).astype(np.float32)
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=64, box=4096.0, g_const=MASS,
            softening_squared=EPS2, capacity=128,
        )
        a = np.asarray(acc)
        a_ex = exact(pos3)
        scale = np.abs(a_ex).max()
        rms = np.sqrt(np.mean((a - a_ex) ** 2)) / scale
        assert int(overflow) == 0
        assert rms < 0.01, f"P3M rms error {rms:.4f}"

    def test_tight_cluster_near_field(self):
        """A cluster tighter than one mesh cell: forces are near-field
        dominated and P³M must still track the exact sum."""
        rng = np.random.default_rng(13)
        n = 128
        pos3 = rng.normal(0, 20, (n, 3)).astype(np.float32)  # cell = 64
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=32, box=2048.0, g_const=MASS,
            softening_squared=EPS2, capacity=256,
        )
        a = np.asarray(acc)
        a_ex = exact(pos3)
        scale = np.abs(a_ex).max()
        rms = np.sqrt(np.mean((a - a_ex) ** 2)) / scale
        assert int(overflow) == 0
        assert rms < 0.02, f"tight-cluster rms {rms:.4f}"

    def test_momentum_conservation(self):
        rng = np.random.default_rng(17)
        pos3 = rng.normal(0, 200, (256, 3)).astype(np.float32)
        acc = np.asarray(p3m.p3m_accel(
            aos(pos3), grid=32, box=2048.0, g_const=MASS,
            softening_squared=EPS2))
        total = np.abs(acc.sum(axis=1))
        assert np.all(total < 1e-2 * np.abs(acc).max() * 256)


@pytest.mark.slow
class TestOverflow:
    def test_overflow_counts_and_degrades_gracefully(self):
        """More particles in one near-cell than capacity: the count is
        reported and the result stays finite (overflowing particles keep
        the mesh force)."""
        rng = np.random.default_rng(19)
        # tight blob at a near-cell CENTER (origin is a cell corner and
        # would straddle 8 cells): r_c = 6.75*64 = 432 -> gn = 4, cell
        # 512 wide, centers at ±256
        pos3 = (rng.normal(0, 5, (64, 3)) + 256.0).astype(np.float32)
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=32, box=2048.0, g_const=MASS,
            softening_squared=EPS2, capacity=16,
        )
        assert int(overflow) == 64 - 16
        assert np.isfinite(np.asarray(acc)).all()

    def test_zero_capacity_equals_mesh_only(self):
        """capacity so small nothing corrects -> pure long-range mesh."""
        rng = np.random.default_rng(23)
        pos3 = rng.normal(0, 300, (64, 3)).astype(np.float32)
        a_full, _ = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=32, box=4096.0, g_const=MASS,
            softening_squared=EPS2, capacity=1,
        )
        assert np.isfinite(np.asarray(a_full)).all()


@pytest.mark.slow
class TestShardedP3M:
    def _cfg(self, n):
        return SimConfig(
            num_particles=n, force_model="p3m",
            pm_grid_size=32, pm_box=4096.0, interaction_scale=1.0 / n,
            p3m_capacity=128,
        )

    def test_mesh_p3m_matches_single_device(self):
        import jax

        from multi_adapter_particles_tpu.parallel import (
            make_mesh, make_sharded_step, shard_state,
        )

        devices = jax.devices()
        if len(devices) < 4:
            pytest.skip("needs 4+ devices")
        n = 1024
        cfg = self._cfg(n)
        ref = integrator.make_step(cfg, donate=False)(
            pinit.initialize_particles_device(n, seed=2)
        )
        mesh = make_mesh(devices[:4])
        sstate = shard_state(pinit.initialize_particles_device(n, seed=2), mesh)
        out = make_sharded_step(cfg, mesh, donate=False)(sstate)
        np.testing.assert_allclose(
            np.asarray(out.position), np.asarray(ref.position),
            rtol=1e-5, atol=1e-3,
        )

    def test_multislice_p3m(self):
        import jax

        from multi_adapter_particles_tpu.parallel import (
            make_sharded_step, shard_state,
        )
        from multi_adapter_particles_tpu.parallel.mesh import (
            make_multislice_mesh,
        )

        devices = jax.devices()
        if len(devices) < 8:
            pytest.skip("needs 8 devices")
        n = 1024
        cfg = self._cfg(n)
        ref = integrator.make_step(cfg, donate=False)(
            pinit.initialize_particles_device(n, seed=4)
        )
        mesh = make_multislice_mesh(2, devices)
        sstate = shard_state(pinit.initialize_particles_device(n, seed=4), mesh)
        out = make_sharded_step(cfg, mesh, donate=False)(sstate)
        np.testing.assert_allclose(
            np.asarray(out.position), np.asarray(ref.position),
            rtol=1e-5, atol=1e-3,
        )


@pytest.mark.slow
class TestIntegration:
    def test_p3m_force_model_steps(self):
        cfg = SimConfig(num_particles=512, force_model="p3m",
                        pm_grid_size=32, pm_box=4096.0,
                        interaction_scale=1.0 / 512)
        step = integrator.make_step(cfg, donate=False)
        s = pinit.initialize_particles_device(512, seed=0)
        for _ in range(3):
            s = step(s)
        pos = np.asarray(s.position)
        assert np.isfinite(pos[:, :512]).all()
        assert pos[3, :512].max() > 0

@pytest.mark.slow
class TestShardedTreeP3M:
    """Tree near field on the mesh: target blocks partition round-robin
    across devices and the partial fields psum back — must match the
    single-device tree step on any mesh shape."""

    def _cfg(self, n):
        return SimConfig(
            num_particles=n, force_model="p3m",
            pm_grid_size=32, pm_box=4096.0, interaction_scale=1.0 / n,
            p3m_near_mode="tree",
        )

    @pytest.mark.parametrize("n_dev,multislice", [(4, False), (8, True)])
    def test_partitioned_tree_matches_single_device(self, n_dev, multislice):
        import jax

        from multi_adapter_particles_tpu.parallel import (
            make_mesh, make_sharded_step, shard_state,
        )
        from multi_adapter_particles_tpu.parallel.mesh import (
            make_multislice_mesh,
        )

        devices = jax.devices()
        if len(devices) < n_dev:
            pytest.skip(f"needs {n_dev}+ devices")
        n = 1024
        cfg = self._cfg(n)
        ref = integrator.make_step(cfg, donate=False)(
            pinit.initialize_particles_device(n, seed=6)
        )
        mesh = (
            make_multislice_mesh(2, devices[:n_dev])
            if multislice
            else make_mesh(devices[:n_dev])
        )
        sstate = shard_state(
            pinit.initialize_particles_device(n, seed=6), mesh
        )
        out = make_sharded_step(cfg, mesh, donate=False)(sstate)
        np.testing.assert_allclose(
            np.asarray(out.position), np.asarray(ref.position),
            rtol=1e-5, atol=1e-3,
        )


class TestPotentialTotal:
    """`p3m_potential_total_with_overflow` (round 5): the scalar-total
    gauge path — long part via the CIC adjoint identity
    (sum_i phi_gathered(x_i) == sum_c phi(c)*rho(c)), near part summed
    on the sweep's gated block-order output. Must match the
    per-particle path's total to f32 reassociation rounding."""

    def _clustered(self, n=768, seed=17):
        rng = np.random.default_rng(seed)
        pos3 = np.concatenate([
            rng.normal(0, 90, (n // 2, 3)),
            rng.normal(250, 50, (n - n // 2, 3)),
        ]).astype(np.float32)
        return pos3

    @pytest.mark.parametrize("half", [False, True])
    def test_total_matches_per_particle_sum(self, half):
        pos = aos(self._clustered())
        kw = dict(grid=16, box=2048.0, g_const=70000.0,
                  softening_squared=25.0, half_pairs=half)
        u, d0 = p3m.p3m_potential_with_overflow(pos, **kw)
        tot, d1 = p3m.p3m_potential_total_with_overflow(pos, **kw)
        assert int(d0) == int(d1) == 0
        ref = float(jnp.sum(u))
        assert float(tot) == pytest.approx(ref, rel=2e-6)

    def test_total_with_out_of_box_particles(self):
        """Out-of-box particles are dropped from the deposit and zeroed
        in the gather — the adjoint identity must survive them."""
        pos3 = self._clustered(seed=29)
        pos3[:9] = 5000.0
        pos = aos(pos3)
        kw = dict(grid=16, box=2048.0, g_const=70000.0,
                  softening_squared=25.0)
        u, _ = p3m.p3m_potential_with_overflow(pos, **kw)
        tot, _ = p3m.p3m_potential_total_with_overflow(pos, **kw)
        assert float(tot) == pytest.approx(float(jnp.sum(u)), rel=2e-6)

    def test_total_only_requires_potential_only(self):
        from multi_adapter_particles_tpu.ops.treeforce import (
            near_field_tree,
        )

        pos = aos(self._clustered(seed=3))
        with pytest.raises(ValueError):
            near_field_tree(
                pos, 2048.0, 70000.0, 25.0, 216.0, 9,
                with_potential=True, total_only=True,
            )
