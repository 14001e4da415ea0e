"""ops/dispatch.py: which implementation runs on which device, and the
budgets derived from the device memory limit."""

import numpy as np
import pytest

import jax

from multi_adapter_particles_tpu.config import RenderConfig, SimConfig
from multi_adapter_particles_tpu.ops import dispatch


class FakeDevice:
    def __init__(self, platform, stats=None):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.fixture
def default_platform(monkeypatch):
    """Make JAX's first device report the given platform."""

    def set_platform(platform, stats=None):
        dev = FakeDevice(platform, stats)
        monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev])
        return dev

    return set_platform


@pytest.mark.parametrize("platform,impl", [
    ("gpu", "triton"),
    ("cpu", "xla"),
    ("rocm", "xla"),
])
def test_choice_follows_default_device(default_platform, platform, impl):
    default_platform(platform)
    assert dispatch.platform() == platform
    assert dispatch.all_pairs_impl() == impl
    assert dispatch.composite_impl() == impl
    assert dispatch.has_kernels() is (impl == "triton")


@pytest.mark.parametrize("platforms,impl", [
    (("gpu", "gpu", "gpu", "gpu"), "triton"),
    (("gpu", "cpu"), "xla"),
    (("cpu",), "xla"),
])
def test_choice_for_a_device_set(platforms, impl):
    devs = [FakeDevice(p) for p in platforms]
    assert dispatch.all_pairs_impl(devs) == impl
    if len(set(platforms)) > 1:
        assert dispatch.platform(devs) == "mixed"


def test_real_cpu_device_selects_xla():
    cpu = jax.devices("cpu")[0]
    assert dispatch.platform(cpu) == "cpu"
    assert dispatch.all_pairs_impl(cpu) == dispatch.XLA
    assert dispatch.composite_impl(cpu) == dispatch.XLA


def test_cpu_engines_never_call_a_kernel(monkeypatch):
    """On a backend without the kernels the XLA path IS the
    implementation: neither kernel wrapper, nor pallas_call at all (so no
    interpreter either), is reached by a frame of the app."""
    from jax.experimental import pallas as pl

    from multi_adapter_particles_tpu.config import AppConfig
    from multi_adapter_particles_tpu.ops import allpairs, composite
    from multi_adapter_particles_tpu.runtime import ParticlesApp

    def boom(*a, **k):
        raise AssertionError("kernel reached on the CPU")

    monkeypatch.setattr(allpairs, "all_pairs_accel_triton", boom)
    monkeypatch.setattr(composite, "composite_rows_triton", boom)
    monkeypatch.setattr(pl, "pallas_call", boom)
    n = 1024
    for fused in (False, True):
        app = ParticlesApp(
            AppConfig(num_particles=n, particle_size=10.0, vsync=False,
                      gui=False),
            SimConfig(num_particles=n, force_model="all_pairs"),
            RenderConfig(width=64, height=64),
            fused=fused, async_timers=False,
        )
        for _ in range(2):
            app.draw()
        app.compute.wait_for_gpu()
        assert np.isfinite(np.asarray(app.compute.positions)).all()
        if not fused:
            assert app.compute.all_pairs_impl == "xla"
        assert app.render.renderer.composite == "xla"
        app.shutdown()


def test_gpu_engine_selects_the_kernel(default_platform):
    """With the default device a GPU, the engines and the renderer name
    the Triton kernels (construction only — nothing is compiled)."""
    from multi_adapter_particles_tpu.render.renderer import Renderer

    dev = default_platform("gpu", {"bytes_limit": 60 * 1024**3})
    assert Renderer(RenderConfig(width=64, height=64)).composite == "triton"
    assert dispatch.all_pairs_impl(dev) == "triton"


class TestMemoryLimit:
    def test_reported_limit_is_used(self):
        dev = FakeDevice("gpu", {"bytes_limit": 12345678})
        assert dispatch.memory_limit_bytes(dev) == 12345678

    @pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
    def test_gpu_without_a_limit_raises(self, stats):
        with pytest.raises(RuntimeError, match="bytes_limit"):
            dispatch.memory_limit_bytes(FakeDevice("gpu", stats))

    def test_cpu_gets_the_stated_default(self):
        assert dispatch.memory_limit_bytes(FakeDevice("cpu")) == \
            dispatch.CPU_MEMORY_BYTES
        assert dispatch.memory_limit_bytes(jax.devices("cpu")[0]) == \
            dispatch.CPU_MEMORY_BYTES

    def test_budgets_follow_the_limit(self, monkeypatch):
        """The tree solve budget (7/8), the row-gather cap (1/8) and the
        renderer's entry budget (1/256) scale with the device memory: an
        80 GB-class card admits the G=384/512 solves a 16 GiB device
        refuses."""
        from multi_adapter_particles_tpu.ops import rowgather, treeforce
        from multi_adapter_particles_tpu.render.renderer import Renderer

        for limit in (16 * 1024**3, 60 * 1024**3):
            monkeypatch.setattr(
                dispatch, "memory_limit_bytes", lambda device=None: limit
            )
            assert treeforce.solve_budget_bytes() == limit * 7 // 8
            assert rowgather._max_line_bytes() == limit // 8
            r = Renderer(RenderConfig(width=64, height=64))
            assert r.entry_budget == limit // 256
            feasible = [g for g in treeforce.AUTO_GRID_LADDER
                        if treeforce.feasible_grid(g)]
            if limit == 16 * 1024**3:
                assert feasible[-1] == 256
            else:
                assert feasible[-1] == 512


def test_sharded_step_takes_the_mesh_choice():
    """The sharded schedule asks dispatch for its whole mesh: a CPU mesh
    runs the XLA partial force, and an explicit interpreted kernel gives
    the same forces."""
    from multi_adapter_particles_tpu.models import init as pinit
    from multi_adapter_particles_tpu.parallel import make_mesh
    from multi_adapter_particles_tpu.parallel.sharded import (
        make_sharded_step, shard_state,
    )

    devs = jax.devices()[:2]
    if len(devs) < 2:
        pytest.skip("needs 2 devices")
    mesh = make_mesh(devs)
    n = 512
    cfg = SimConfig(num_particles=n, force_model="all_pairs")
    s0 = pinit.initialize_particles_device(n, seed=1)
    a = make_sharded_step(cfg, mesh, donate=False)(shard_state(s0, mesh))
    b = make_sharded_step(cfg, mesh, donate=False,
                          all_pairs_impl="triton-interpret")(
        shard_state(s0, mesh))
    dv_a = np.asarray(a.velocity) - np.asarray(s0.velocity)
    dv_b = np.asarray(b.velocity) - np.asarray(s0.velocity)
    assert np.abs(dv_a - dv_b).max() <= 1e-5 * np.abs(dv_a).max()
