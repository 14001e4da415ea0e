"""Conservation diagnostics: energy/momentum gauges, sync correction,
oracle parity, and the app wiring (`-diagnostics K`)."""

import json

import numpy as np
import pytest

from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models import (
    diagnostics,
    init as pinit,
    integrator,
)
from multi_adapter_particles_tpu.models.state import ParticleState


def _circular_orbit_state(n_pad: int = 128):
    """One real particle on an exact circular orbit of the softened well:
    v² = M r² / (r² + eps²)^{3/2} (padding parked)."""
    from multi_adapter_particles_tpu.models.state import PAD_POSITION

    m, eps2, r = 70000.0, 25.0, 400.0
    v = np.sqrt(m * r * r / (r * r + eps2) ** 1.5)
    pos = np.full((4, n_pad), PAD_POSITION, np.float32)
    pos[3, :] = 0.0
    vel = np.zeros((3, n_pad), np.float32)
    pos[:3, 0] = (r, 0.0, 0.0)
    vel[:, 0] = (0.0, v, 0.0)
    import jax.numpy as jnp

    return ParticleState(jnp.asarray(pos), jnp.asarray(vel))


class TestPairwisePotential:
    def test_matches_double_loop_oracle(self):
        import jax.numpy as jnp

        rng = np.random.default_rng(3)
        n, n_pad = 48, 128
        g, eps2 = 7.5, 25.0
        p = np.zeros((4, n_pad), np.float32)
        p[:3, :n] = rng.uniform(-100, 100, (3, n)).astype(np.float32)
        p[:3, n:] = 1e9  # parked padding
        mask = (np.arange(n_pad) < n).astype(np.float32)

        pe, acc = diagnostics.pairwise_potential_and_accel(
            jnp.asarray(p), jnp.asarray(mask), g, eps2
        )

        pe_ref, acc_ref = 0.0, np.zeros((3, n))
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                d = p[:3, j] - p[:3, i]
                d2 = float(d @ d) + eps2
                pe_ref -= 0.5 * g / np.sqrt(d2)
                acc_ref[:, i] += g * d / d2**1.5
        assert float(pe) == pytest.approx(pe_ref, rel=1e-5)
        np.testing.assert_allclose(
            np.asarray(acc)[:, :n], acc_ref, rtol=2e-4, atol=1e-6
        )
        # padding rows must not contribute force or energy
        assert np.all(np.abs(np.asarray(acc)[:, n:]) < 1e-6)

    def test_padding_pairs_excluded(self):
        """Two parked (co-located) padding particles would add 1/eps pair
        terms if the mask leaked."""
        import jax.numpy as jnp

        n_pad = 128
        p = np.full((4, n_pad), 1e9, np.float32)
        p[3, :] = 0.0
        p[:3, 0] = 0.0
        mask = (np.arange(n_pad) < 1).astype(np.float32)
        pe, acc = diagnostics.pairwise_potential_and_accel(
            jnp.asarray(p), jnp.asarray(mask), 1.0, 25.0
        )
        assert float(pe) == pytest.approx(0.0, abs=1e-7)
        # padding TARGETS see the one real source at ~1e9 distance
        # (~1e-19 — they are masked out of every sum downstream); what
        # must be exactly absent is any 1/eps pair between parked rows
        assert np.all(np.abs(np.asarray(acc)) < 1e-12)


class TestConservation:
    def test_circular_orbit_energy_bounded(self):
        """Semi-implicit Euler is symplectic at damping=1: synchronized
        energy on a circular orbit stays within a tight bound for many
        periods (a non-symplectic Euler would drift secularly)."""
        cfg = SimConfig(num_particles=1, force_model="central_well")
        step = integrator.make_step(cfg, donate=False)
        diag = diagnostics.make_diagnostics(cfg)
        state = _circular_orbit_state()
        e0 = float(diag(state)["energy"])
        worst = 0.0
        for _ in range(40):
            for _ in range(25):
                state = step(state)
            e = float(diag(state)["energy"])
            worst = max(worst, abs(e - e0) / abs(e0))
        assert worst < 2e-4, f"energy drift {worst:.2e}"

    def test_sync_removes_sawtooth(self):
        """The raw stored velocity lives at the half step; its energy
        carries an O(dt) v·a oscillation the half-kick sync removes.
        Needs an ECCENTRIC orbit (on a circular one v ⊥ a kills the
        first-order term), and baselines taken after the first step
        (the initial condition's velocity is not yet half-step-lagged)."""
        import jax.numpy as jnp

        cfg = SimConfig(num_particles=1, force_model="central_well")
        step = integrator.make_step(cfg, donate=False)
        d_sync = diagnostics.make_diagnostics(cfg, sync=True)
        d_raw = diagnostics.make_diagnostics(cfg, sync=False)
        state = _circular_orbit_state()
        state = ParticleState(state.position, state.velocity * jnp.float32(0.8))
        state = step(state)
        e0s = float(d_sync(state)["energy"])
        e0r = float(d_raw(state)["energy"])
        errs, errr = [], []
        for _ in range(200):
            state = step(state)
            errs.append(abs(float(d_sync(state)["energy"]) - e0s))
            errr.append(abs(float(d_raw(state)["energy"]) - e0r))
        # raw-velocity energy error is dominated by the half-step offset
        assert max(errs) < 0.2 * max(errr)

    def test_all_pairs_momentum_and_energy(self):
        """Antisymmetric pair forces conserve momentum; symplectic + exact
        forces keep the synchronized energy drift small."""
        n = 512
        cfg = SimConfig(num_particles=n, force_model="all_pairs")
        step = integrator.make_step(cfg, donate=False)
        diag = diagnostics.make_diagnostics(cfg)
        state = pinit.initialize_particles_device(n, seed=7)
        d0 = {k: float(v) for k, v in diag(state).items()}
        for _ in range(100):
            state = step(state)
        d1 = {k: float(v) for k, v in diag(state).items()}
        # |P| scale: N * cluster speed ~ 512 * 15; drift must be fp noise
        assert abs(d1["momentum_mag"] - d0["momentum_mag"]) < 0.3
        drift = abs(d1["energy"] - d0["energy"]) / abs(d0["energy"])
        assert drift < 5e-3, f"energy drift {drift:.2e}"

    def test_damping_dissipates(self):
        cfg = SimConfig(
            num_particles=1, force_model="central_well", damping=0.99
        )
        step = integrator.make_step(cfg, donate=False)
        diag = diagnostics.make_diagnostics(cfg)
        state = _circular_orbit_state()
        k0 = float(diag(state)["kinetic"])
        for _ in range(200):
            state = step(state)
        assert float(diag(state)["kinetic"]) < 0.9 * k0


class TestAppWiring:
    def test_diagnostics_flag_publishes_gauges(self, tmp_path):
        from multi_adapter_particles_tpu.app import main

        out = tmp_path / "m.json"
        rc = main([
            "-numparticles", "1024", "-steps", "12", "-nogui", "-novsync",
            "-force", "all_pairs", "-diagnostics", "5",
            "-metrics", str(out),
        ])
        assert rc == 0
        m = json.loads(out.read_text())
        g = m["gauges"]
        for key in ("energy", "kinetic", "potential", "energy_drift",
                    "momentum_mag", "angular_momentum_mag"):
            assert key in g, key
        assert abs(g["energy_drift"]) < 1e-2
        assert np.isfinite(g["energy"])


class TestMeshPotential:
    """The P³M-split potential gauge (VERDICT r3 #3): `-diagnostics`
    usable at the reference-default 4M, pinned vs the exact O(N²) sum."""

    def _clustered_state(self, n, n_pad=None, seed=0):
        import jax.numpy as jnp

        from multi_adapter_particles_tpu.models.state import PAD_POSITION

        rng = np.random.default_rng(seed)
        n_pad = n_pad or -(-n // 128) * 128
        pos = np.full((4, n_pad), PAD_POSITION, np.float32)
        pos[3, :] = 0.0
        pos[:3, :n] = np.concatenate([
            rng.normal(0, 120, (3, n // 2)),
            rng.normal(300, 60, (3, n - n // 2)),
        ], axis=1)
        vel = np.zeros((3, n_pad), np.float32)
        vel[:, :n] = rng.normal(0, 2, (3, n))
        return ParticleState(jnp.asarray(pos), jnp.asarray(vel))

    def test_mesh_energy_matches_exact_clustered(self):
        """Total mesh potential within ~1e-3 of the exact pairwise sum
        on a clustered scene (measured 1.3e-4 at these settings)."""
        n = 4096
        cfg = SimConfig(num_particles=n, force_model="pm_grid",
                        pm_grid_size=32)
        state = self._clustered_state(n)
        exact_fn = diagnostics.make_diagnostics(cfg, potential_mode="exact")
        mesh_fn = diagnostics.make_diagnostics(cfg, potential_mode="mesh")
        ve, vm = exact_fn(state), mesh_fn(state)
        pe, pm_ = float(ve["potential"]), float(vm["potential"])
        assert pm_ == pytest.approx(pe, rel=1e-3)
        assert int(vm["diag_dropped_pairs"]) == 0
        # kinetic differs only through the half-kick accel source (exact
        # vs tree-P3M, <0.1% RMS apart)
        assert float(vm["kinetic"]) == pytest.approx(
            float(ve["kinetic"]), rel=1e-3
        )
        assert float(vm["energy"]) == pytest.approx(
            float(ve["energy"]), rel=1e-3
        )

    @pytest.mark.slow
    def test_mesh_energy_matches_exact_demo_65k(self):
        """THE pinning config (VERDICT r3 #3): the two-cluster demo init
        at 65,536 — the adversarial scene — mesh vs exact potential."""
        n = 65_536
        cfg = SimConfig(num_particles=n, force_model="pm_grid",
                        pm_grid_size=64)
        state = pinit.initialize_particles_device(n, seed=42)
        exact_fn = diagnostics.make_diagnostics(cfg, potential_mode="exact")
        vm = None
        probe = diagnostics.DiagnosticsProbe(cfg, 1, potential_mode="mesh")
        fn = probe._build(state, external_accel=False)
        # ^ sizes the tree pair budget from the scene
        ve, vm = exact_fn(state), fn(state)
        assert int(vm["diag_dropped_pairs"]) == 0
        assert float(vm["potential"]) == pytest.approx(
            float(ve["potential"]), rel=1e-3
        )

    def test_auto_mode_thresholds(self):
        """auto = exact at small N (no dropped-pairs key), mesh above
        262K (key present) — checked structurally, no big compute."""
        cfg_small = SimConfig(num_particles=4096, force_model="pm_grid",
                              pm_grid_size=32)
        state = self._clustered_state(4096)
        keys = diagnostics.make_diagnostics(cfg_small)(state).keys()
        assert "diag_dropped_pairs" not in keys
        assert diagnostics._EXACT_MAX_N == 262_144

    def test_probe_publishes_mesh_gauges(self):
        """DiagnosticsProbe in mesh mode publishes the standard gauges
        plus diag_dropped_pairs and energy_drift."""
        from multi_adapter_particles_tpu.utils.metrics import MetricsRegistry

        n = 2048
        cfg = SimConfig(num_particles=n, force_model="pm_grid",
                        pm_grid_size=32)
        state = self._clustered_state(n)
        metrics = MetricsRegistry()
        probe = diagnostics.DiagnosticsProbe(cfg, 1, potential_mode="mesh")
        assert probe.maybe_publish(0, state, metrics)
        vals = metrics.snapshot() if hasattr(metrics, "snapshot") else None
        got = {g for g in ("energy", "energy_drift", "diag_dropped_pairs")}
        text = repr(vals) if vals is not None else repr(vars(metrics))
        for k in got:
            assert k in text

    def test_potential_only_equals_fused(self):
        """`mesh_potential_only` (the external-accel gauge's potential)
        must equal `mesh_potential_and_accel`'s potential to fusion-level
        rounding: same scalar solve, same pair list, same accumulation
        order — only the force work is skipped. (On the Pallas sweep the
        au chain is literally unchanged; the CPU XLA fallback refuses
        one contraction when the force channels disappear, ~1 ULP of the
        total.)"""
        n = 2048
        cfg = SimConfig(num_particles=n, force_model="pm_grid",
                        pm_grid_size=32)
        state = self._clustered_state(n)
        g_scale = cfg.mass * cfg.interaction_scale
        pot_f, _accel, drop_f = diagnostics.mesh_potential_and_accel(
            state.position, g_scale, cfg.softening_squared,
            grid=32, box=cfg.pm_box,
        )
        pot_o, drop_o = diagnostics.mesh_potential_only(
            state.position, g_scale, cfg.softening_squared,
            grid=32, box=cfg.pm_box,
        )
        assert float(pot_f) == pytest.approx(float(pot_o), rel=1e-6)
        assert int(drop_f) == int(drop_o)

    def test_external_accel_path_equals_internal(self):
        """Feeding the external-accel gauge the SAME accel the fused
        gauge computes reproduces every gauge (to fusion-level rounding
        of the potential-only sweep) — pins the two code paths to each
        other."""
        n = 2048
        cfg = SimConfig(num_particles=n, force_model="pm_grid",
                        pm_grid_size=32)
        state = self._clustered_state(n)
        g_scale = cfg.mass * cfg.interaction_scale
        _pot, accel, _drop = diagnostics.mesh_potential_and_accel(
            state.position, g_scale, cfg.softening_squared,
            grid=32, box=cfg.pm_box,
        )
        fused = diagnostics.make_diagnostics(cfg, potential_mode="mesh")
        ext = diagnostics.make_diagnostics(
            cfg, potential_mode="mesh", external_accel=True
        )
        vi = fused(state)
        ve = ext(state, accel)
        assert set(vi.keys()) == set(ve.keys())
        for k in vi:
            assert float(vi[k]) == pytest.approx(
                float(ve[k]), rel=1e-6, abs=1e-6
            ), k

    def test_probe_run_accel_auto(self):
        """A pm_grid run above the exact threshold auto-threads the run's
        own PM force into the half-kick (use_run_accel); the published
        potential is identical to the fused probe's, and the energies
        agree to the accel-source difference (PM vs tree, few %% on a
        small correction term)."""
        from multi_adapter_particles_tpu.utils.metrics import MetricsRegistry

        n = 2048
        cfg = SimConfig(num_particles=n, force_model="pm_grid",
                        pm_grid_size=32)
        state = self._clustered_state(n)
        m_fast = MetricsRegistry()
        m_full = MetricsRegistry()
        fast = diagnostics.DiagnosticsProbe(cfg, 1, potential_mode="mesh")
        full = diagnostics.DiagnosticsProbe(cfg, 1, potential_mode="mesh",
                                            use_run_accel=False)
        assert fast.use_run_accel        # auto-on: pm_grid + mesh gauge
        assert not full.use_run_accel
        assert fast.maybe_publish(0, state, m_fast)
        assert full.maybe_publish(0, state, m_full)
        gf, gu = m_fast.gauges, m_full.gauges
        assert gf["potential"] == pytest.approx(gu["potential"], rel=1e-6)
        assert gf["energy"] == pytest.approx(gu["energy"], rel=1e-3)
        # central_well / exact-range configs stay on the fused path
        assert not diagnostics.DiagnosticsProbe(
            SimConfig(num_particles=n, force_model="central_well"), 1
        ).use_run_accel

    def test_gauge_grid_table(self):
        """The gauge sizes its own mesh above 262K (tree-P3M optima: 192
        @1M, 256 @4M); small N keeps the config's mesh."""
        gg = diagnostics._gauge_grid
        assert gg(4096, 32) == 32
        assert gg(262_144, 64) == 64
        assert gg(1_048_576, 128) == 192
        assert gg(4_194_304, 128) == 256
        assert gg(4_194_304, 256) == 256
