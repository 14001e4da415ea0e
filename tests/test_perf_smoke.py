"""Performance smoke tests: the main paths at real sizes on the GPU.

They carry the `gpu` marker and skip anywhere JAX finds no GPU; the CPU
suite forces the CPU, so run them on the card with

    MAP_TEST_BACKEND=gpu python -m pytest tests/test_perf_smoke.py -m gpu -s

Until a first GPU record exists to anchor a threshold, they assert
finite results of the right shape and print the times they measured.
"""

import time

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    """The GPU device, decided when the test runs (never at import)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (backend is {dev.platform})")
    return dev


def _timed(fn, reps):
    from multi_adapter_particles_tpu.utils.timers import sync

    out = fn()
    sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(out)
    return out, (time.perf_counter() - t0) * 1000.0 / reps


def test_allpairs_interactions_per_second(gpu):
    from multi_adapter_particles_tpu.config import SimConfig
    from multi_adapter_particles_tpu.models import init as pinit, integrator
    from multi_adapter_particles_tpu.ops import dispatch

    n = 131072
    cfg = SimConfig(num_particles=n, force_model="all_pairs")
    step = integrator.make_step(cfg, donate=False)
    state = pinit.initialize_particles_device(n, seed=0)
    out, ms = _timed(lambda: step(state), 5)
    assert np.isfinite(np.asarray(out.position)).all()
    print(f"all-pairs ({dispatch.all_pairs_impl(gpu)}) @{n}: {ms:.3f} "
          f"ms/step, {n * n / ms * 1e3 / 1e12:.4f} Tpairs/s")


@pytest.mark.parametrize("n", [262_144, 4_194_304])
def test_render_frame_time(gpu, n):
    from multi_adapter_particles_tpu.config import RenderConfig
    from multi_adapter_particles_tpu.models import init as pinit
    from multi_adapter_particles_tpu.render.camera import Camera
    from multi_adapter_particles_tpu.render.renderer import Renderer

    cfg = RenderConfig(width=1024, height=1024)
    renderer = Renderer(cfg)
    camera = Camera(position=cfg.camera_position)
    pos = pinit.initialize_particles_device(n, seed=42).position
    out, ms = _timed(
        lambda: renderer.render_arrays(pos, camera, 2.5, 0.15).frame, 10
    )
    frame = np.asarray(out)
    assert frame.shape == (1024, 1024, 3) and np.isfinite(frame).all()
    assert frame.max() > 0
    print(f"render ({renderer.composite}) @{n}: {ms:.3f} ms")


def test_pm_step_time(gpu):
    from multi_adapter_particles_tpu.config import SimConfig
    from multi_adapter_particles_tpu.models import init as pinit, integrator

    n = 4_194_304
    cfg = SimConfig(num_particles=n, force_model="pm_grid", pm_grid_size=128,
                    interaction_scale=1.0 / n)
    step = integrator.make_step(cfg, donate=False)
    state = pinit.initialize_particles_device(n, seed=42)
    out, ms = _timed(lambda: step(state), 5)
    assert np.isfinite(np.asarray(out.position)).all()
    print(f"pm_grid G=128 @{n}: {ms:.3f} ms/step")


def test_tree_accel_time(gpu):
    from multi_adapter_particles_tpu.models import init as pinit
    from multi_adapter_particles_tpu.ops import p3m
    from multi_adapter_particles_tpu.ops.treeforce import host_pair_budget

    n, grid, box = 262_144, 128, 2048.0
    pos = pinit.initialize_particles_device(n, seed=42).position
    r_c = 6.75 * box / grid
    budget = host_pair_budget(np.asarray(pos), box, r_c,
                              max(int(box // r_c), 1))

    def accel():
        return p3m.p3m_accel_with_overflow(
            pos, grid=grid, box=box, g_const=70000.0,
            softening_squared=25.0, near_mode="tree", pair_budget=budget,
        )

    (acc, dropped), ms = _timed(accel, 5)
    assert int(dropped) == 0
    assert np.isfinite(np.asarray(acc)).all()
    print(f"tree-P3M G={grid} @{n}: {ms:.3f} ms/accel")
