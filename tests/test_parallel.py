"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

The analog of a fake backend (SURVEY §4): correctness of the ring
all-pairs exchange, sharded central-well, elastic re-sharding, and the
mesh engine — all without real multi-chip hardware.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models import init as pinit, integrator
from multi_adapter_particles_tpu.parallel import (
    MeshComputeEngine,
    make_mesh,
    make_sharded_step,
    reshard_state,
    shard_state,
)
from multi_adapter_particles_tpu.parallel.mesh import particle_sharding

N = 1024  # padded count == N; divisible by 8 shards


def _ref_step(cfg, donate=False):
    return integrator.make_step(cfg, donate=donate)


class TestShardedCentralWell:
    def test_matches_single_device(self, eight_devices):
        mesh = make_mesh(eight_devices)
        cfg = SimConfig(num_particles=N)
        state = pinit.initialize_particles_device(N, seed=7)
        ref = _ref_step(cfg)(state)

        sstate = shard_state(pinit.initialize_particles_device(N, seed=7), mesh)
        step = make_sharded_step(cfg, mesh, donate=False)
        out = step(sstate)
        np.testing.assert_allclose(
            np.asarray(out.position), np.asarray(ref.position),
            rtol=1e-6, atol=1e-4,
        )

    def test_output_stays_sharded(self, eight_devices):
        mesh = make_mesh(eight_devices)
        cfg = SimConfig(num_particles=N)
        sstate = shard_state(pinit.initialize_particles_device(N, seed=0), mesh)
        out = make_sharded_step(cfg, mesh, donate=False)(sstate)
        assert out.position.sharding == particle_sharding(mesh)


class TestRingAllPairs:
    @pytest.mark.parametrize("ndev", [2, 4, 8])
    def test_ring_matches_single_device(self, eight_devices, ndev):
        mesh = make_mesh(eight_devices[:ndev])
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        state = pinit.initialize_particles_device(N, seed=3)
        ref = _ref_step(cfg)(state)

        sstate = shard_state(pinit.initialize_particles_device(N, seed=3), mesh)
        out = make_sharded_step(cfg, mesh, donate=False, bit_stable=False)(sstate)
        # ring accumulation order differs from the single-pass sum -> fp32
        # reassociation tolerance
        np.testing.assert_allclose(
            np.asarray(out.position), np.asarray(ref.position),
            rtol=1e-4, atol=1e-3,
        )
        np.testing.assert_allclose(
            np.asarray(out.velocity), np.asarray(ref.velocity),
            rtol=1e-4, atol=1e-3,
        )

    def test_multi_step_trajectory(self, eight_devices):
        mesh = make_mesh(eight_devices[:4])
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        ref_state = pinit.initialize_particles_device(N, seed=1)
        step_ref = _ref_step(cfg)
        sstate = shard_state(pinit.initialize_particles_device(N, seed=1), mesh)
        step_sh = make_sharded_step(cfg, mesh, donate=False, bit_stable=False)
        for _ in range(5):
            ref_state = step_ref(ref_state)
            sstate = step_sh(sstate)
        np.testing.assert_allclose(
            np.asarray(sstate.position), np.asarray(ref_state.position),
            rtol=1e-3, atol=1e-2,
        )

    def test_num_sim_freeze(self, eight_devices):
        mesh = make_mesh(eight_devices[:4])
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        sstate = shard_state(pinit.initialize_particles_device(N, seed=2), mesh)
        before = np.asarray(sstate.position)
        out = make_sharded_step(cfg, mesh, donate=False, bit_stable=False)(sstate, 256)
        after = np.asarray(out.position)
        assert not np.array_equal(before[:, :256], after[:, :256])
        np.testing.assert_array_equal(before[:, 256:], after[:, 256:])


class TestResharding:
    def test_bitwise_across_mesh_change(self, eight_devices):
        mesh8 = make_mesh(eight_devices)
        mesh2 = make_mesh(eight_devices[:2])
        state = shard_state(pinit.initialize_particles_device(N, seed=4), mesh8)
        before = np.asarray(state.position)
        moved = reshard_state(state, mesh2)
        assert moved.position.sharding == particle_sharding(mesh2)
        np.testing.assert_array_equal(before, np.asarray(moved.position))

    def test_to_single_device(self, eight_devices):
        mesh = make_mesh(eight_devices)
        state = shard_state(pinit.initialize_particles_device(N, seed=4), mesh)
        single = reshard_state(state, eight_devices[3])
        assert single.position.devices() == {eight_devices[3]}

    def test_trajectory_continues_after_reshard(self, eight_devices):
        """Drain -> re-place -> resume == uninterrupted run (CopyState
        guarantee, applied to meshes)."""
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        mesh4 = make_mesh(eight_devices[:4])
        mesh8 = make_mesh(eight_devices)
        ref = shard_state(pinit.initialize_particles_device(N, seed=5), mesh4)
        step4 = make_sharded_step(cfg, mesh4, donate=False)
        ref = step4(step4(ref))

        state = shard_state(pinit.initialize_particles_device(N, seed=5), mesh4)
        state = step4(state)
        state = reshard_state(state, mesh8)
        step8 = make_sharded_step(cfg, mesh8, donate=False)
        state = step8(state)
        np.testing.assert_allclose(
            np.asarray(state.position), np.asarray(ref.position),
            rtol=1e-4, atol=1e-3,
        )


class TestMeshEngine:
    def test_engine_runs_and_counts(self, eight_devices):
        mesh = make_mesh(eight_devices[:4])
        eng = MeshComputeEngine(
            SimConfig(num_particles=N, force_model="all_pairs"), mesh, seed=0
        )
        eng.simulate()
        eng.simulate()
        assert eng.get_fence_value() == 2
        eng.wait_for_gpu()
        assert np.isfinite(np.asarray(eng.positions)).all()

    def test_migration_from_single_device_engine(self, eight_devices):
        from multi_adapter_particles_tpu.runtime import ComputeEngine

        cfg = SimConfig(num_particles=N)
        single = ComputeEngine(cfg, eight_devices[0], seed=6)
        single.simulate()
        single.wait_for_gpu()
        before = np.asarray(single.positions)
        mesh = make_mesh(eight_devices)
        eng = MeshComputeEngine(cfg, mesh, prev=single)
        np.testing.assert_array_equal(before, np.asarray(eng.positions))
        assert eng.get_fence_value() == 1
        eng.simulate()

    def test_snapshot_restore(self, eight_devices):
        mesh = make_mesh(eight_devices[:2])
        eng = MeshComputeEngine(SimConfig(num_particles=N), mesh, seed=8)
        eng.simulate()
        snap = eng.snapshot()
        eng.simulate()
        eng.restore(snap)
        np.testing.assert_array_equal(
            np.asarray(eng.positions), np.asarray(snap.position)
        )


class TestMeshInOrchestrator:
    def test_mesh_compute_role(self, eight_devices):
        from multi_adapter_particles_tpu.config import AppConfig, RenderConfig
        from multi_adapter_particles_tpu.runtime import ParticlesApp

        app = ParticlesApp(
            AppConfig(num_particles=N, particle_size=10.0),
            SimConfig(num_particles=N, force_model="all_pairs"),
            RenderConfig(width=256, height=256),
            mesh_devices=4,
        )
        assert "Mesh Compute" in app.metrics.gauges["mode_banner"]
        app.draw()
        app.draw()
        assert app.compute.get_fence_value() == 2
        frame = np.asarray(app.render.last_frame)
        assert np.isfinite(frame).all() and frame.max() > 0
        app.shutdown()

    def test_live_mesh_rescale(self, eight_devices):
        """2-device mesh -> 8-device mesh -> single device, trajectory
        continuous (the runtime shard-rebalancing config)."""
        from multi_adapter_particles_tpu.config import AppConfig, RenderConfig
        from multi_adapter_particles_tpu.runtime import ParticlesApp
        from multi_adapter_particles_tpu.runtime.compute_engine import ComputeEngine

        cfg = SimConfig(num_particles=N)
        ref = ComputeEngine(cfg, eight_devices[0], seed=0, donate=False)
        app = ParticlesApp(
            AppConfig(num_particles=N, particle_size=10.0),
            cfg,
            RenderConfig(width=256, height=256),
            mesh_devices=2,
        )
        app.draw(); ref.simulate()
        app.set_mesh_devices(8)
        assert app.compute.mesh.devices.size == 8
        app.draw(); ref.simulate()
        app.set_mesh_devices(1)
        app.draw(); ref.simulate()
        app.compute.wait_for_gpu(); ref.wait_for_gpu()
        np.testing.assert_allclose(
            np.asarray(app.compute.positions), np.asarray(ref.positions),
            rtol=1e-5, atol=1e-3,
        )
        app.shutdown()


class TestMultiSlice:
    """2-D (slices, particles) mesh — the DCN analog, hierarchical ring."""

    @pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2)])
    def test_hierarchical_ring_matches_single_device(self, eight_devices, shape):
        from multi_adapter_particles_tpu.parallel.mesh import (
            make_multislice_mesh,
        )

        ns, nc = shape
        mesh = make_multislice_mesh(ns, eight_devices[: ns * nc])
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        ref = _ref_step(cfg)(pinit.initialize_particles_device(N, seed=3))

        sstate = shard_state(pinit.initialize_particles_device(N, seed=3), mesh)
        out = make_sharded_step(cfg, mesh, donate=False, bit_stable=False)(sstate)
        np.testing.assert_allclose(
            np.asarray(out.position), np.asarray(ref.position),
            rtol=1e-4, atol=1e-3,
        )

    def test_central_well_multislice(self, eight_devices):
        from multi_adapter_particles_tpu.parallel.mesh import (
            make_multislice_mesh,
        )

        mesh = make_multislice_mesh(2, eight_devices)
        cfg = SimConfig(num_particles=N)
        ref = _ref_step(cfg)(pinit.initialize_particles_device(N, seed=1))
        sstate = shard_state(pinit.initialize_particles_device(N, seed=1), mesh)
        out = make_sharded_step(cfg, mesh, donate=False)(sstate)
        np.testing.assert_allclose(
            np.asarray(out.position), np.asarray(ref.position),
            rtol=1e-6, atol=1e-4,
        )

    def test_num_sim_on_multislice(self, eight_devices):
        from multi_adapter_particles_tpu.parallel.mesh import (
            make_multislice_mesh,
        )

        mesh = make_multislice_mesh(2, eight_devices)
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        sstate = shard_state(pinit.initialize_particles_device(N, seed=2), mesh)
        before = np.asarray(sstate.position)
        out = make_sharded_step(cfg, mesh, donate=False)(sstate, 256)
        after = np.asarray(out.position)
        assert not np.array_equal(before[:, :256], after[:, :256])
        np.testing.assert_array_equal(before[:, 256:], after[:, 256:])

    def test_mesh_engine_on_multislice(self, eight_devices):
        from multi_adapter_particles_tpu.parallel.mesh import (
            make_multislice_mesh,
        )

        mesh = make_multislice_mesh(2, eight_devices)
        eng = MeshComputeEngine(
            SimConfig(num_particles=N, force_model="all_pairs"), mesh, seed=0
        )
        eng.simulate()
        eng.wait_for_gpu()
        assert np.isfinite(np.asarray(eng.positions)).all()


class TestBitStableTrajectories:
    """SURVEY §7 hard part 5: bit-stable trajectories across re-sharding.

    The default all-pairs schedule (bit_stable=True) reduces sources in
    identical global order on every device, so runs on ANY mesh size —
    including a single device — produce the same bits.
    """

    def test_bitwise_across_mesh_sizes(self, eight_devices):
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        ref_state = pinit.initialize_particles_device(N, seed=11)
        step_ref = _ref_step(cfg)
        for _ in range(5):
            ref_state = step_ref(ref_state)
        ref_pos = np.asarray(ref_state.position)
        ref_vel = np.asarray(ref_state.velocity)

        for ndev in (1, 2, 4, 8):
            mesh = make_mesh(eight_devices[:ndev])
            sstate = shard_state(
                pinit.initialize_particles_device(N, seed=11), mesh
            )
            step = make_sharded_step(cfg, mesh, donate=False)
            for _ in range(5):
                sstate = step(sstate)
            np.testing.assert_array_equal(
                np.asarray(sstate.position), ref_pos,
                err_msg=f"positions diverge at mesh size {ndev}",
            )
            np.testing.assert_array_equal(
                np.asarray(sstate.velocity), ref_vel,
                err_msg=f"velocities diverge at mesh size {ndev}",
            )

    def test_bitwise_multislice_vs_flat(self, eight_devices):
        from multi_adapter_particles_tpu.parallel.mesh import (
            make_multislice_mesh,
        )

        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        flat = make_mesh(eight_devices[:4])
        twod = make_multislice_mesh(2, eight_devices[:4])
        a = shard_state(pinit.initialize_particles_device(N, seed=12), flat)
        b = shard_state(pinit.initialize_particles_device(N, seed=12), twod)
        step_a = make_sharded_step(cfg, flat, donate=False)
        step_b = make_sharded_step(cfg, twod, donate=False)
        for _ in range(3):
            a = step_a(a)
            b = step_b(b)
        np.testing.assert_array_equal(
            np.asarray(a.position), np.asarray(b.position)
        )

    def test_bitwise_across_live_rescale(self, eight_devices):
        """Stepping THROUGH a mesh rescale produces the same bits as an
        uninterrupted run (the CopyState guarantee, exact)."""
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        mesh2 = make_mesh(eight_devices[:2])
        mesh8 = make_mesh(eight_devices)
        ref = shard_state(pinit.initialize_particles_device(N, seed=13), mesh2)
        step2 = make_sharded_step(cfg, mesh2, donate=False)
        step8 = make_sharded_step(cfg, mesh8, donate=False)
        for _ in range(4):
            ref = step2(ref)

        state = shard_state(
            pinit.initialize_particles_device(N, seed=13), mesh2
        )
        state = step2(state)
        state = step2(state)
        state = reshard_state(state, mesh8)
        state = step8(state)
        state = step8(state)
        np.testing.assert_array_equal(
            np.asarray(state.position), np.asarray(ref.position)
        )
        np.testing.assert_array_equal(
            np.asarray(state.velocity), np.asarray(ref.velocity)
        )


@pytest.mark.slow
class TestBootstrap:
    @pytest.mark.parametrize("nprocs", [2, 4])
    def test_multi_process_cluster(self, nprocs):
        """Spawn a real nprocs-process jax.distributed CPU cluster (2
        virtual devices each): initialize, build the global mesh, step the
        sharded engine, and check the pod trajectory matches a local run
        bit-for-bit. The 4-process shape also drives the distributed-FFT
        PM slab pipeline (psum_scatter + both all_to_all transposes)
        across 4 hosts — the pod-readiness gate of VERDICT r2 #9."""
        import socket
        import subprocess
        import sys as _sys

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]

        worker = str(
            __import__("pathlib").Path(__file__).parent / "_bootstrap_worker.py"
        )
        env = {
            k: v for k, v in __import__("os").environ.items()
            if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
        }
        procs = [
            subprocess.Popen(
                [_sys.executable, worker, str(port), str(pid), str(nprocs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env,
            )
            for pid in range(nprocs)
        ]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=240)
                outs.append(out)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail("bootstrap workers timed out:\n" + "\n".join(outs))
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
            assert "BOOTSTRAP_OK" in out, out

    def test_noop_on_single_host(self, monkeypatch):
        from multi_adapter_particles_tpu.parallel import bootstrap

        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        assert bootstrap.initialize() is False
        assert bootstrap.is_primary()
        assert bootstrap.local_render_device() in jax.devices()
