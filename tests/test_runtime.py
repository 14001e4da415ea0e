"""Runtime layer tests: engines, orchestrator, live reconfiguration.

Runs on the CPU backend (conftest forces JAX_PLATFORMS=cpu with 8 virtual
devices), so every 'adapter' is a CPU device — which exercises the
cross-device copy path (device 0 -> device 1) exactly like the reference's
multi-adapter mode, minus real ICI.
"""

import jax
import numpy as np
import pytest

from multi_adapter_particles_tpu.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_tpu.models import init as pinit, integrator
from multi_adapter_particles_tpu.runtime import (
    ComputeEngine,
    ParticlesApp,
    RenderEngine,
    enumerate_adapters,
    assign_adapters,
)
from multi_adapter_particles_tpu.runtime.devices import mode_banner

N = 512
SMALL_RENDER = RenderConfig(width=256, height=256)


def small_app(**kw):
    app_cfg = AppConfig(num_particles=N, particle_size=10.0)
    sim_cfg = SimConfig(num_particles=N)
    return ParticlesApp(app_cfg, sim_cfg, SMALL_RENDER, **kw)


class TestDevices:
    def test_enumerate_nonempty(self):
        adapters = enumerate_adapters()
        assert len(adapters) >= 1
        assert all(a.index == i for i, a in enumerate(adapters))

    def test_assign_default_splits_with_two_accelerators(self):
        """Two adapters -> split roles by default, like the reference
        (`Particles.cpp:212-243`: multi-adapter mode is not opt-in)."""
        adapters = enumerate_adapters()
        accel = [a for a in adapters if a.is_accelerator] or adapters
        c, r = assign_adapters(adapters)
        if len(accel) > 1:
            assert c.device != r.device
            assert (c.index, r.index) == (accel[0].index, accel[1].index)
        else:
            assert c.device == r.device

    def test_assign_explicit(self):
        adapters = enumerate_adapters()
        if len(adapters) < 2:
            pytest.skip("needs 2+ devices")
        c, r = assign_adapters(adapters, compute_index=0, render_index=1)
        assert c.device != r.device
        c, r = assign_adapters(adapters, compute_index=0, render_index=0)
        assert c.device == r.device

    def test_mode_banner(self):
        adapters = enumerate_adapters()
        c, r = assign_adapters(adapters, compute_index=0, render_index=0)
        assert "Async Compute" in mode_banner(c, r)
        if len(adapters) > 1:
            c, r = assign_adapters(adapters, compute_index=0, render_index=1)
            assert "Multi-Adapter Split" in mode_banner(c, r)


class TestComputeEngine:
    def test_simulate_matches_bare_integrator(self):
        dev = jax.devices()[0]
        eng = ComputeEngine(SimConfig(num_particles=N), dev, seed=3)
        ref_state = pinit.initialize_particles_device(N, seed=3)
        step = integrator.make_step(SimConfig(num_particles=N), donate=False)
        for _ in range(5):
            eng.simulate()
            ref_state = step(ref_state)
        assert eng.get_fence_value() == 5
        # donating vs non-donating compilations may fuse differently -> tiny
        # ulp-level drift is acceptable
        np.testing.assert_allclose(
            np.asarray(eng.positions),
            np.asarray(ref_state.position),
            rtol=1e-6, atol=2e-5,
        )

    def test_migration_preserves_state(self):
        devs = jax.devices()
        if len(devs) < 2:
            pytest.skip("needs 2+ devices")
        eng = ComputeEngine(SimConfig(num_particles=N), devs[0], seed=1)
        for _ in range(3):
            eng.simulate()
        before = np.asarray(eng.positions)
        eng2 = ComputeEngine(
            SimConfig(num_particles=N), devs[1], prev=eng
        )
        # bitwise-continuous across the migration (CopyState guarantee)
        np.testing.assert_array_equal(before, np.asarray(eng2.positions))
        assert eng2.get_fence_value() == 3
        assert devs[1] in eng2.positions.devices()
        eng2.simulate()  # still steppable on the new device

    def test_snapshot_restore(self):
        dev = jax.devices()[0]
        eng = ComputeEngine(SimConfig(num_particles=N), dev, seed=2)
        eng.simulate()
        snap = eng.snapshot()
        eng.simulate()
        eng.simulate()
        eng.restore(snap)
        np.testing.assert_array_equal(
            np.asarray(eng.positions), np.asarray(snap.position)
        )


class TestRenderEngine:
    def test_zero_copy_same_device(self):
        dev = jax.devices()[0]
        eng = RenderEngine(SMALL_RENDER, dev)
        state = pinit.initialize_particles_device(N, seed=0)
        local = eng.copy_simulation_results(state.position)
        assert local is state.position  # async mode: no copy at all
        assert eng.metrics.counters.get("transfer_bytes") is None

    def test_cross_device_copy(self):
        devs = jax.devices()
        if len(devs) < 2:
            pytest.skip("needs 2+ devices")
        eng = RenderEngine(SMALL_RENDER, devs[1])
        state = pinit.initialize_particles_device(N, seed=0)  # on devs[0]
        local = eng.copy_simulation_results(state.position)
        assert devs[1] in local.devices()
        np.testing.assert_array_equal(np.asarray(local), np.asarray(state.position))
        assert eng.metrics.counters["transfer_bytes"] == state.position.shape[1] * 16

    def test_num_copy_stale_tail(self):
        devs = jax.devices()
        if len(devs) < 2:
            pytest.skip("needs 2+ devices")
        eng = RenderEngine(SMALL_RENDER, devs[1])
        state = pinit.initialize_particles_device(N, seed=0)
        full = np.asarray(state.position)
        # first copy moves only 128 columns; the tail must stay at the pad
        local = np.asarray(eng.copy_simulation_results(state.position, num_copy=128))
        np.testing.assert_array_equal(local[:, :128], full[:, :128])
        assert np.all(local[:3, 128:] == 1.0e9)  # stale = never-written pad
        # second copy with a different prefix updates in place
        state2 = pinit.initialize_particles_device(N, seed=9)
        full2 = np.asarray(state2.position)
        local2 = np.asarray(eng.copy_simulation_results(state2.position, num_copy=256))
        np.testing.assert_array_equal(local2[:, :256], full2[:, :256])
        np.testing.assert_array_equal(local2[:, 256:], local[:, 256:])

    def test_draw_and_present(self):
        dev = jax.devices()[0]
        eng = RenderEngine(SMALL_RENDER, dev)
        state = pinit.initialize_particles_device(N, seed=0)
        app = AppConfig(num_particles=N, particle_size=10.0)
        out = eng.draw(state.position, app, num_draw=N)
        assert out.frame.shape == (256, 256, 3)
        eng.present()
        frame = np.asarray(out.frame)
        assert np.isfinite(frame).all()
        assert frame.max() > 0.0  # something splatted


class TestParticlesApp:
    def test_frames_advance_sim_and_render(self):
        app = small_app()
        for _ in range(3):
            app.draw()
        assert app.frame_count == 3
        assert app.compute.get_fence_value() == 3
        assert app.render.frame_count == 3
        frame = np.asarray(app.render.last_frame)
        assert frame.max() > 0.0
        app.shutdown()

    def test_draw_disabled(self):
        app = small_app(draw_enabled=False)
        app.draw()
        assert app.render.frame_count == 0
        assert app.compute.get_fence_value() == 1

    def test_decoupled_counts(self):
        cfg = AppConfig(
            num_particles=N, particle_size=10.0,
            linked=False, num_sim=128, num_draw=64, num_copy=N,
        )
        app = ParticlesApp(cfg, SimConfig(num_particles=N), SMALL_RENDER)
        before = np.asarray(app.compute.positions)
        app.draw()
        app.compute.wait_for_gpu()
        after = np.asarray(app.compute.positions)
        # particles >= num_sim frozen bit-exactly (short-dispatch analog)
        assert not np.array_equal(before[:, :128], after[:, :128])
        np.testing.assert_array_equal(before[:, 128:N], after[:, 128:N])

    def test_live_compute_reassignment(self):
        if len(jax.devices()) < 2:
            pytest.skip("needs 2+ devices")
        # pin both roles to device 0 so the cycle below is a real change
        app = small_app(compute_adapter=0, render_adapter=0)
        app.draw()
        app.compute.wait_for_gpu()
        pos_before = np.asarray(app.compute.positions)
        fence_before = app.compute.get_fence_value()
        app.set_compute_adapter(1)
        app.draw()  # reconfiguration happens post-present inside draw()
        # next frame runs on the new device
        app.draw()
        assert app.adapters[1].device in app.compute.positions.devices()
        assert app.compute.get_fence_value() == fence_before + 2
        assert not app.async_mode  # render stayed on device 0
        app.shutdown()

    def test_trajectory_continuous_across_reassignment(self):
        if len(jax.devices()) < 2:
            pytest.skip("needs 2+ devices")
        # Reference guarantee: state migrates, trajectory continues
        # (Compute::CopyState). Compare against an uninterrupted run.
        app = small_app()
        ref = ComputeEngine(
            SimConfig(num_particles=N), jax.devices()[0], seed=0
        )
        app.draw()
        ref.simulate()
        app.set_compute_adapter(1)
        app.draw()  # migrate at end of this frame
        ref.simulate()
        app.draw()
        ref.simulate()
        app.compute.wait_for_gpu()
        np.testing.assert_allclose(
            np.asarray(app.compute.positions),
            np.asarray(ref.positions),
            rtol=1e-6, atol=1e-4,
        )
        app.shutdown()

    def test_profile_mode_records_stages(self):
        app = small_app(profile_every=1)
        app.draw()
        app.draw()
        assert "simulate" in app.metrics.stages
        assert "render" in app.metrics.stages
        assert app.metrics.stages["simulate"].milliseconds > 0.0
        d = app.metrics.as_dict()
        assert d["counters"]["frames"] == 2
        app.shutdown()


class TestNumSimBlockRounding:
    def test_rounds_up_to_block_size(self):
        """Reference dispatches ceil(numSim/64) whole groups
        (Compute.cpp:1041): numSim=100 simulates 128 particles."""
        from multi_adapter_particles_tpu.models import integrator

        dev = jax.devices()[0]
        eng = ComputeEngine(SimConfig(num_particles=N), dev, seed=0)
        before = np.asarray(eng.positions)
        eng.simulate(num_sim=100)
        eng.wait_for_gpu()
        after = np.asarray(eng.positions)
        assert not np.array_equal(before[:, :128], after[:, :128])
        np.testing.assert_array_equal(before[:, 128:N], after[:, 128:N])


class TestFusedMode:
    def test_fused_matches_split_pipeline(self):
        """Fused one-program frame == split engines: same trajectory, same
        stale-by-one frame contract."""
        cfg_app = AppConfig(num_particles=N, particle_size=10.0)
        cfg_sim = SimConfig(num_particles=N)
        split = ParticlesApp(cfg_app, cfg_sim, SMALL_RENDER, seed=0)
        fused = ParticlesApp(cfg_app, cfg_sim, SMALL_RENDER, seed=0, fused=True)
        for _ in range(3):
            split.draw()
            fused.draw()
        split.compute.wait_for_gpu()
        fused.compute.wait_for_gpu()
        np.testing.assert_allclose(
            np.asarray(split.compute.positions),
            np.asarray(fused.compute.positions),
            rtol=1e-5, atol=1e-3,
        )
        np.testing.assert_allclose(
            np.asarray(split.render.last_frame),
            np.asarray(fused.render.last_frame),
            rtol=1e-4, atol=1e-4,
        )
        split.shutdown()
        fused.shutdown()

    def test_fused_chunked_matches_split_chunked(self):
        """Above chunk_threshold the fused frame program inlines the
        id-ordered chunk fold (renderer._chunked_fold) instead of the
        single-pass _render; with matching thresholds its frames must
        equal split mode's chunked render (same association)."""
        cfg_app = AppConfig(num_particles=N, particle_size=10.0)
        cfg_sim = SimConfig(num_particles=N)
        split = ParticlesApp(cfg_app, cfg_sim, SMALL_RENDER, seed=0)
        fused = ParticlesApp(cfg_app, cfg_sim, SMALL_RENDER, seed=0,
                             fused=True)
        for r in (split.render.renderer, fused.compute.renderer):
            r.chunk_threshold = 256  # N=512 -> 2+ chunks on both paths
            r.chunk_size = 256
        for _ in range(3):
            split.draw()
            fused.draw()
        split.compute.wait_for_gpu()
        fused.compute.wait_for_gpu()
        assert split.render.renderer._last_sort_n < N  # fold engaged
        np.testing.assert_allclose(
            np.asarray(split.render.last_frame),
            np.asarray(fused.render.last_frame),
            rtol=1e-4, atol=1e-4,
        )
        split.shutdown()
        fused.shutdown()

    def test_fused_present_auto_raises_dup(self):
        """Split parity for the deferred auto-raise (round-4 review
        catch): a truncating fused frame must grow the dup window at
        present() AND rebuild the frame program — the old present never
        raised, and the jit closure baked dup in forever, so oversized
        sprites stayed truncated for the rest of the run."""
        from multi_adapter_particles_tpu.models.state import ParticleState
        from multi_adapter_particles_tpu.runtime.fused import FusedEngine

        app = AppConfig(num_particles=1, particle_size=200.0)
        eng = FusedEngine(
            SimConfig(num_particles=1), RenderConfig(width=256, height=256),
            jax.devices()[0],
        )
        pos = np.array([[0.0, 0.0, 0.0, 0.0]], dtype=np.float32)
        eng.restore(ParticleState.from_aos(pos, np.zeros((1, 3), np.float32)))
        out = eng.frame(app)
        assert int(out.truncated) > 0  # giant sprite exceeds the 2x2 window
        dup0 = (eng.renderer.dup_y, eng.renderer.dup_x)
        prog0 = eng._fused
        eng.present()
        assert (eng.renderer.dup_y, eng.renderer.dup_x) != dup0
        assert eng._fused is not prog0  # next frame retraces with new dup
        out2 = eng.frame(app)
        assert int(out2.truncated) == 0  # lossless after the raise

    def test_fused_draw_toggle(self):
        app = small_app()
        fused = ParticlesApp(
            AppConfig(num_particles=N, particle_size=10.0),
            SimConfig(num_particles=N), SMALL_RENDER, fused=True,
        )
        fused.draw_enabled = False
        fused.draw()  # still advances the sim
        assert fused.compute.get_fence_value() == 1
        fused.draw_enabled = True
        fused.draw()
        assert np.asarray(fused.render.last_frame).max() > 0
        fused.shutdown()

    def test_fused_rejects_split_devices(self):
        if len(jax.devices()) < 2:
            pytest.skip("needs 2+ devices")
        with pytest.raises(ValueError, match="fused"):
            ParticlesApp(
                AppConfig(num_particles=N),
                SimConfig(num_particles=N), SMALL_RENDER,
                compute_adapter=0, render_adapter=1, fused=True,
            )


class TestRenderReassignment:
    def test_live_render_reassignment(self):
        """Render engine rebuild on a new device mid-run; camera state
        survives; sim unaffected (Particles.cpp:488-509)."""
        if len(jax.devices()) < 2:
            pytest.skip("needs 2+ devices")
        app = small_app(compute_adapter=0, render_adapter=0)
        app.draw()
        app.render.camera.yaw += 0.25  # mutate camera state
        yaw = app.render.camera.yaw
        app.set_render_adapter(1)
        app.draw()  # reconfigure post-present
        app.draw()
        assert app.render.device == app.adapters[1].device
        assert app.render.camera.yaw == yaw  # survived the rebuild
        assert not app.async_mode  # compute stayed on device 0
        frame = np.asarray(app.render.last_frame)
        assert np.isfinite(frame).all() and frame.max() > 0
        app.shutdown()


class TestFullscreenReconfiguration:
    """Live fullscreen flip = drain + render-engine rebuild at the new
    resolution (`Particles.cpp:458-463,488-509`, swap-chain machinery
    `Render.cpp:287-413`); camera + learned dup window survive, the
    trajectory is untouched."""

    FS_RENDER = RenderConfig(
        width=256, height=256, fullscreen_width=128, fullscreen_height=64
    )

    def _app(self, **kw):
        return ParticlesApp(
            AppConfig(num_particles=N, particle_size=10.0),
            SimConfig(num_particles=N),
            self.FS_RENDER,
            **kw,
        )

    def test_split_mode_flip_and_back(self):
        app = self._app()
        ref = ComputeEngine(
            SimConfig(num_particles=N), app.compute_adapter.device, seed=0
        )
        app.draw()
        ref.simulate()
        assert np.asarray(app.render.last_frame).shape == (256, 256, 3)
        app.render.camera.yaw += 0.25
        yaw = app.render.camera.yaw
        app.render.renderer.dup_y = 3  # learned auto-raise state
        app.app.fullscreen = True
        app.draw()  # reconfigures post-present: NEXT frame is fullscreen
        ref.simulate()
        app.draw()
        ref.simulate()
        assert app.render.config.width == 128
        assert app.render.config.height == 64
        assert np.asarray(app.render.last_frame).shape == (64, 128, 3)
        assert app.render.camera.yaw == yaw       # camera survived
        assert app.render.renderer.dup_y == 3     # dup window survived
        # trajectory is bit-continuous across the rebuild
        app.compute.wait_for_gpu()
        np.testing.assert_array_equal(
            np.asarray(app.compute.positions), np.asarray(ref.positions)
        )
        app.app.fullscreen = False                # and back to windowed
        app.draw()
        app.draw()
        assert np.asarray(app.render.last_frame).shape == (256, 256, 3)
        app.shutdown()

    def test_starts_fullscreen(self):
        app = self._app()
        try:
            app2 = ParticlesApp(
                AppConfig(
                    num_particles=N, particle_size=10.0, fullscreen=True
                ),
                SimConfig(num_particles=N),
                self.FS_RENDER,
            )
            app2.draw()
            assert np.asarray(app2.render.last_frame).shape == (64, 128, 3)
            app2.shutdown()
        finally:
            app.shutdown()

    def test_fused_mode_flip(self):
        app = self._app(fused=True)
        app.draw()
        app.compute.wait_for_gpu()
        before = np.asarray(app.compute.positions)
        app.app.fullscreen = True
        app.draw()  # reconfigures post-present (migrates state via prev=)
        app.draw()
        assert np.asarray(app.render.last_frame).shape == (64, 128, 3)
        # sim state migrated, not reset: positions kept evolving from
        # `before`, still finite and in the demo radius envelope
        app.compute.wait_for_gpu()
        after = np.asarray(app.compute.positions)
        assert np.isfinite(after[:, :N]).all()
        assert not np.array_equal(before, after)
        assert app.compute.get_fence_value() == 3
        app.shutdown()


class TestFusedPm:
    def test_fused_with_pm_grid(self):
        """Fused single-program frame works with the PM force model."""
        app = ParticlesApp(
            AppConfig(num_particles=N, particle_size=10.0),
            SimConfig(num_particles=N, force_model="pm_grid",
                      pm_grid_size=32, pm_box=4096.0,
                      interaction_scale=1.0 / N),
            SMALL_RENDER,
            fused=True,
        )
        app.draw()
        app.draw()
        app.compute.wait_for_gpu()
        pos = np.asarray(app.compute.positions)
        assert np.isfinite(pos[:, :N]).all()
        assert np.asarray(app.render.last_frame).max() > 0
        app.shutdown()

    def test_fused_with_p3m(self):
        """Fused single-program frame works with the P³M force model."""
        app = ParticlesApp(
            AppConfig(num_particles=N, particle_size=10.0),
            SimConfig(num_particles=N, force_model="p3m",
                      pm_grid_size=32, pm_box=4096.0,
                      interaction_scale=1.0 / N, p3m_capacity=32),
            SMALL_RENDER,
            fused=True,
        )
        app.draw()
        app.draw()
        app.compute.wait_for_gpu()
        pos = np.asarray(app.compute.positions)
        assert np.isfinite(pos[:, :N]).all()
        assert np.asarray(app.render.last_frame).max() > 0
        app.shutdown()


class TestReviewRegressions:
    """Pinned fixes from the round-1 code review."""

    def test_splice_after_zero_copy_alias(self):
        """Zero-copy frame then a partial copy: must not donate the aliased
        compute-state buffer into the splice."""
        dev = jax.devices()[0]
        eng = RenderEngine(SMALL_RENDER, dev)
        ceng = ComputeEngine(SimConfig(num_particles=N), dev, seed=0)
        local = eng.copy_simulation_results(ceng.positions)  # alias
        assert local is ceng.positions
        ceng.simulate()  # donates the aliased buffer
        out = np.asarray(
            eng.copy_simulation_results(ceng.positions, num_copy=128)
        )
        np.testing.assert_array_equal(
            out[:, :128], np.asarray(ceng.positions)[:, :128]
        )
        ceng.simulate()  # compute state must still be healthy
        ceng.wait_for_gpu()

    def test_zero_size_sprites_no_nan(self):
        dev = jax.devices()[0]
        eng = RenderEngine(SMALL_RENDER, dev)
        state = pinit.initialize_particles_device(N, seed=0)
        app = AppConfig(num_particles=N, particle_size=0.0)
        out = eng.draw(state.position, app, num_draw=N)
        frame = np.asarray(out.frame)
        assert np.isfinite(frame).all()
        assert frame.sum() == 0.0  # size-0 sprites draw nothing

    def test_debug_survives_reassignment(self):
        if len(jax.devices()) < 2:
            pytest.skip("needs 2+ devices")
        app = small_app()
        app.debug = True  # post-hoc: only the rebuild path is under test
        app.set_compute_adapter(1)
        app.draw()
        app.draw()
        # rebuilt engine must not donate (debug invariant)
        before = app.compute.positions
        app.compute.simulate()
        assert not before.is_deleted()
        app.shutdown()

    def test_fused_adapter_move_rebuilds_engine(self):
        if len(jax.devices()) < 2:
            pytest.skip("needs 2+ devices")
        fused = ParticlesApp(
            AppConfig(num_particles=N, particle_size=10.0),
            SimConfig(num_particles=N), SMALL_RENDER, fused=True,
        )
        fused.draw()
        fused.compute.wait_for_gpu()
        fence = fused.compute.get_fence_value()
        fused.set_compute_adapter(1)
        fused.set_render_adapter(1)
        fused.draw()  # reconfigures post-present
        fused.draw()
        assert fused.fused_engine.device == fused.adapters[1].device
        assert fused.compute.get_fence_value() == fence + 2
        fused.shutdown()

    def test_mesh_collapse_on_compute_cycle(self):
        """Cycling the compute adapter while a mesh is active collapses to
        a single-device engine AND drops the mesh bookkeeping (advisor
        finding: stale mesh banner + async_mode)."""
        if len(jax.devices()) < 2:
            pytest.skip("needs 2+ devices")
        app = small_app(mesh_devices=2)
        app.draw()
        assert app.mesh_devices == 2
        app.set_compute_adapter(
            (app.compute_adapter.index + 1) % len(app.adapters)
        )
        app.draw()  # reconfigures post-present
        assert app.mesh_devices == 0
        assert "mesh" not in app.metrics.gauges
        assert "Mesh" not in app.metrics.gauges["mode_banner"]
        app.draw()
        app.shutdown()
