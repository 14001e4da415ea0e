"""Benchmark of the main paths on one GPU: the all-pairs headline plus
staged frame, render and force-model configurations.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, "extra": [...]}
The top level is the headline, pairwise interactions/sec of the
all-pairs force at 1M fp32, with the implementation that ran; "extra"
carries the staged configurations:

  - pm_grid self-gravity step at 4M, G=128;
  - tree-P3M accel at 262K (G=128) and 1M (G=192) on the demo scene;
  - render-only at 262K and 4M, 1024x1024;
  - split-mode frame (sim + render, dispatch-ahead) at 262K and 4M,
    1280x720 — the 4M one is the reference's shipped default
    (`defines.h:44-45`, central well + draw);
  - fused-mode frame at 262K and 4M, 1280x720, with `vs_split`;
  - the 16.8M pm_grid + 1024x1024 chunked-render frame.

Every result is a host-clock time around work that ends in a device
sync. There is no baseline yet: the first GPU record becomes it.

Run `python bench.py` on a machine with an NVIDIA GPU; without one it
exits non-zero. `--smoke` runs the same stages at toy sizes on any
backend (CI); those numbers measure nothing.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_KERNEL = 1_048_576
N_FRAME = 262_144
N_PM = 4_194_304


def _bench_kernel(jax, n: int) -> dict:
    from multi_adapter_particles_tpu.config import SimConfig
    from multi_adapter_particles_tpu.models import init as pinit, integrator
    from multi_adapter_particles_tpu.ops import dispatch
    from multi_adapter_particles_tpu.utils.timers import sync

    impl = dispatch.all_pairs_impl()
    cfg = SimConfig(num_particles=n, force_model="all_pairs")
    step = integrator.make_step(
        cfg, accel_fn=integrator.make_accel_fn_for(cfg, impl), donate=True
    )
    state = pinit.initialize_particles_device(n, seed=42)
    np_pad = state.padded_count

    state = step(state)  # warm-up/compile
    sync(state.position)

    timed_steps = 3
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        state = step(state)
    sync(state.position)
    dt = time.perf_counter() - t0
    pairs_per_sec = float(timed_steps) * np_pad * np_pad / dt
    return {
        "metric": f"pairwise interactions/sec @ {n} particles "
        f"(all-pairs softened gravity, fp32, {impl})",
        "value": pairs_per_sec,
        "unit": "pairs/s",
        "implementation": impl,
    }


def _bench_frame(jax, n: int, warm: int, timed: int,
                 sim_kw: dict | None = None,
                 width: int = 1280, height: int = 720,
                 tag: str = "") -> dict:
    """Full split-mode frame loop (default: 720p central-well —
    BASELINE.json config #3; `sim_kw`/`width`/`height` parameterize the
    16.8M pm_grid stage)."""
    from multi_adapter_particles_tpu.config import (
        AppConfig, RenderConfig, SimConfig,
    )
    from multi_adapter_particles_tpu.runtime.orchestrator import ParticlesApp
    from multi_adapter_particles_tpu.utils.timers import sync

    app = ParticlesApp(
        AppConfig(num_particles=n, vsync=False, gui=False),
        SimConfig(num_particles=n, **(sim_kw or {})),
        RenderConfig(width=width, height=height),
        seed=42,
        async_timers=False,
    )

    def drain():
        app.compute.wait_for_gpu()
        if app.render.last_frame is not None:
            sync(app.render.last_frame)

    for _ in range(warm):
        app.draw()
    drain()
    t0 = time.perf_counter()
    for _ in range(timed):
        app.draw()
    drain()
    ms = (time.perf_counter() - t0) * 1000.0 / timed
    app.shutdown()
    return {
        "metric": f"split-mode frame ms @ {n} particles, {width}x{height} "
        f"(sim+render, dispatch-ahead{tag})",
        "value": ms,
        "unit": "ms/frame",
    }


def _bench_render(jax, n: int, warm: int, timed: int) -> dict:
    """Render-only @1024^2, through the renderer's chosen composite."""
    from multi_adapter_particles_tpu.config import RenderConfig
    from multi_adapter_particles_tpu.models import init as pinit
    from multi_adapter_particles_tpu.render.camera import Camera
    from multi_adapter_particles_tpu.render.renderer import Renderer
    from multi_adapter_particles_tpu.utils.timers import sync

    cfg = RenderConfig(width=1024, height=1024)
    renderer = Renderer(cfg)
    camera = Camera(position=cfg.camera_position)
    state = pinit.initialize_particles_device(n, seed=42)
    sync(state.position)

    out = None
    for _ in range(warm):
        out = renderer.render_arrays(state.position, camera, 2.5, 0.15)
    sync(out.frame)
    t0 = time.perf_counter()
    for _ in range(timed):
        out = renderer.render_arrays(state.position, camera, 2.5, 0.15)
    sync(out.frame)
    ms = (time.perf_counter() - t0) * 1000.0 / timed
    return {
        "metric": f"render-only ms @ {n} particles, 1024x1024 exact splat",
        "value": ms,
        "unit": "ms/frame",
    }


def _bench_fused(jax, n: int, warm: int, timed: int) -> dict:
    """Fused single-program frame @720p (the async-compute analog,
    `Compute.cpp:956-987`)."""
    from multi_adapter_particles_tpu.config import (
        AppConfig, RenderConfig, SimConfig,
    )
    from multi_adapter_particles_tpu.runtime.orchestrator import ParticlesApp
    from multi_adapter_particles_tpu.utils.timers import sync

    app = ParticlesApp(
        AppConfig(num_particles=n, vsync=False, gui=False),
        SimConfig(num_particles=n),
        RenderConfig(width=1280, height=720),
        seed=42,
        fused=True,
        async_timers=False,
    )

    def drain():
        app.compute.wait_for_gpu()
        if app.render.last_frame is not None:
            sync(app.render.last_frame)

    for _ in range(warm):
        app.draw()
    drain()
    t0 = time.perf_counter()
    for _ in range(timed):
        app.draw()
    drain()
    ms = (time.perf_counter() - t0) * 1000.0 / timed
    app.shutdown()
    return {
        "metric": f"fused-mode frame ms @ {n} particles, 1280x720 "
        "(single-program sim+render)",
        "value": ms,
        "unit": "ms/frame",
    }


def _bench_pm(jax, n: int, grid: int, steps: int) -> dict:
    """pm_grid self-gravity step."""
    from multi_adapter_particles_tpu.config import SimConfig
    from multi_adapter_particles_tpu.models import init as pinit, integrator
    from multi_adapter_particles_tpu.utils.timers import sync

    cfg = SimConfig(
        num_particles=n, force_model="pm_grid", pm_grid_size=grid,
        interaction_scale=1.0 / n,
    )
    step = integrator.make_step(cfg, donate=True)
    state = pinit.initialize_particles_device(n, seed=42)
    state = step(state)
    sync(state.position)
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    sync(state.position)
    ms = (time.perf_counter() - t0) * 1000.0 / steps
    return {
        "metric": f"pm_grid self-gravity step ms @ {n} particles, G={grid}",
        "value": ms,
        "unit": "ms/step",
    }


def _bench_tree(jax, n: int, grid: int, reps: int) -> dict:
    """Tree-P3M exactness mode on the demo init (VERDICT r2 #2): <1% RMS
    on ANY scene at a fraction of the exact all-pairs cost."""
    import numpy as np

    from multi_adapter_particles_tpu.models import init as pinit
    from multi_adapter_particles_tpu.ops import p3m
    from multi_adapter_particles_tpu.ops.treeforce import host_pair_budget
    from multi_adapter_particles_tpu.utils.timers import sync

    box = 2048.0
    state = pinit.initialize_particles_device(n, seed=42)
    sync(state.position)
    pos = state.position
    r_c = 6.75 * box / grid
    gn = max(int(box // r_c), 1)
    budget = host_pair_budget(np.asarray(pos), box, r_c, gn)

    def accel():
        return p3m.p3m_accel_with_overflow(
            pos, grid=grid, box=box, g_const=70000.0,
            softening_squared=25.0, near_mode="tree", pair_budget=budget,
        )

    acc, dropped = accel()
    sync(acc)
    t0 = time.perf_counter()
    for _ in range(reps):
        acc, dropped = accel()
    sync(acc)
    ms = (time.perf_counter() - t0) * 1000.0 / reps
    return {
        "metric": f"tree-P3M accel ms @ {n} particles (demo scene), G={grid}",
        "value": ms,
        "unit": "ms/accel",
        "dropped_pairs": int(dropped),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="toy sizes on any backend (CI); not a measurement")
    args = ap.parse_args(argv)

    from multi_adapter_particles_tpu.utils import compilecache

    compilecache.enable("auto")

    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if args.smoke:
        n_kernel, n_frame, n_pm, n_16m = 8192, 8192, 8192, 8192
        g_pm, g_tree, g_tree_1m = 32, 16, 16
        warm, timed, reps = 2, 3, 2
    elif dev.platform == "gpu":
        n_kernel, n_frame, n_pm, n_16m = N_KERNEL, N_FRAME, N_PM, 16_777_216
        g_pm, g_tree, g_tree_1m = 128, 128, 192
        warm, timed, reps = 10, 30, 5
    else:
        print(f"bench: no GPU (backend {dev.platform}); pass --smoke for "
              "the toy-size run", file=sys.stderr)
        return 2

    def note(msg):
        print(msg, file=sys.stderr, flush=True)

    note(f"bench: {device}")
    t0 = time.perf_counter()
    errors = []
    try:
        headline = _bench_kernel(jax, n_kernel)
        note(f"bench: kernel done at +{time.perf_counter()-t0:.0f}s")
    except Exception as e:  # noqa: BLE001 — recorded, exits non-zero
        headline = {"metric": f"pairwise interactions/sec @ {n_kernel} "
                    "particles", "error": f"{type(e).__name__}: {e}"}
        errors.append("kernel")
        note(f"bench: kernel FAILED: {e}")

    extra = []
    for name, fn in (
        ("pm", lambda: _bench_pm(jax, n_pm, g_pm, reps)),
        ("tree", lambda: _bench_tree(jax, n_frame, g_tree, reps)),
        ("tree-1m", lambda: _bench_tree(jax, n_kernel, g_tree_1m, reps)),
        ("render", lambda: _bench_render(jax, n_frame, warm, timed)),
        ("render-4m", lambda: _bench_render(jax, n_pm, warm, timed)),
        ("frame", lambda: _bench_frame(jax, n_frame, warm, timed)),
        ("frame-4m", lambda: _bench_frame(jax, n_pm, warm, timed)),
        ("fused", lambda: _bench_fused(jax, n_frame, warm, timed)),
        ("fused-4m", lambda: _bench_fused(jax, n_pm, warm, timed)),
        ("frame-16m", lambda: _bench_frame(
            jax, n_16m, min(warm, 3), min(timed, 8),
            sim_kw={"force_model": "pm_grid", "pm_grid_size": g_pm},
            width=1024, height=1024, tag="; pm_grid self-gravity",
        )),
    ):
        try:
            extra.append(fn())
            note(f"bench: {name} done at +{time.perf_counter()-t0:.0f}s")
        except Exception as e:  # noqa: BLE001 — recorded, exits non-zero
            extra.append({"metric": name, "error": f"{type(e).__name__}: {e}"})
            errors.append(name)
            note(f"bench: {name} FAILED: {e}")
    # fused vs split head-to-head AT THE SAME N (>1 = fused faster)
    for e in extra:
        metric = e.get("metric", "")
        if "fused-mode frame" not in metric or "value" not in e:
            continue
        n_tag = metric.split("@", 1)[1].split("particles")[0].strip()
        split_ms = next(
            (s["value"] for s in extra
             if "split-mode frame" in s.get("metric", "")
             and f"@ {n_tag} particles" in s["metric"] and "value" in s),
            None,
        )
        if split_ms:
            e["vs_split"] = split_ms / e["value"]
    out = dict(headline)
    out["device"] = device
    out["smoke"] = bool(args.smoke)
    out["extra"] = extra
    print(json.dumps(out))
    if errors:
        note(f"bench: stages failed: {errors}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
