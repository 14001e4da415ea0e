#!/usr/bin/env python3
"""Smoke test of the main paths on one NVIDIA GPU, through the entry
points a user calls, at the reference's full size.

    python chip_smoke.py                 # one card: all default phases
    python chip_smoke.py --four-cards    # the multi-device paths only
    python chip_smoke.py --rehearse      # tiny sizes on the CPU (no result line)

Default phases, in one process, in turn:

1. device     — JAX sees a GPU; its kind, count and memory limit.
2. reference  — `app.main` at the shipped default (central well, N =
                4,194,304, 1024x1024 exact splat, split frame loop on one
                card), then again with `-fused`. Finite positions and a
                non-blank frame, non-zero "simulate"/"render" stage rows,
                the perf extension active, and 512 particles against the
                float64 oracle over the same steps.
3. allpairs   — the all-pairs force at 1M: the chosen implementation and
                the XLA scan, each timed; the chosen one against a float64
                NumPy sum for 1024 targets over all sources.
4. composite  — 262K and 4M frames at 1024x1024 with the chosen composite
                and with the XLA scan, each timed, compared pixel by pixel.
5. models     — `app.main` with pm_grid at 4M (G=128) and tree-P3M at 262K.

The first line printed is the card's name and power limit from
nvidia-smi; the last is the JSON result. Any failed check raises, and the
script exits non-zero without the result line. JAX is held to CUDA, so a
broken CUDA set-up fails instead of falling back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PHASES = ("device", "reference", "allpairs", "composite", "models")


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of a passing run."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}}
    )


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def rms_rel(got, want) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


class Sizes:
    """Full sizes on the card; tiny ones for a CPU rehearsal."""

    def __init__(self, rehearse: bool):
        small = self.rehearse = rehearse
        self.n_ref = 8192 if small else 4_194_304
        self.steps = 30
        self.n_allpairs = 4096 if small else 1_048_576
        self.n_targets = 256 if small else 1024
        self.n_render = (2048, 8192) if small else (262_144, 4_194_304)
        self.n_pm = 8192 if small else 4_194_304
        self.g_pm = 32 if small else 128
        self.n_tree = 8192 if small else 262_144
        self.g_tree = 32 if small else 128
        self.n_mesh_allpairs = 4096 if small else 262_144
        self.window = 256 if small else 1024


def run_app(args, out_dir):
    """One `app.main` run; returns (metrics dict, checkpoint, wall s)."""
    from multi_adapter_particles_tpu import app
    from multi_adapter_particles_tpu.utils.checkpoint import load_checkpoint

    os.makedirs(out_dir, exist_ok=True)
    metrics = os.path.join(out_dir, "metrics.json")
    ckpt = os.path.join(out_dir, "state.npz")
    t0 = time.perf_counter()
    rc = app.main(list(args) + ["-metrics", metrics, "-checkpoint", ckpt])
    wall = time.perf_counter() - t0
    assert rc == 0, f"app.main {args} returned {rc}"
    with open(metrics) as f:
        m = json.load(f)
    return m, load_checkpoint(ckpt), wall


def phase_device(jax, sz, out):
    devs = jax.devices()
    d = devs[0]
    stats = d.memory_stats() or {}
    print(f"device: {d.platform} {d.device_kind} x{len(devs)} "
          f"bytes_limit={stats.get('bytes_limit')}", flush=True)
    assert d.platform == "gpu", f"expected a GPU, JAX reports {d.platform}"
    assert stats.get("bytes_limit"), "GPU reports no memory limit"


def phase_reference(jax, sz, out):
    import numpy as np

    from multi_adapter_particles_tpu.models import init as pinit, oracle

    from multi_adapter_particles_tpu.config import SimConfig
    from multi_adapter_particles_tpu.models import integrator

    n = sz.n_ref
    # the 512 compared particles, spread over the whole id range, and
    # their initial state (the device init is deterministic in N, seed)
    idx = np.linspace(0, n - 1, 512).astype(np.int64)
    s0 = pinit.initialize_particles_device(n, seed=0)
    p0 = np.asarray(s0.position)[:, idx].T.astype(np.float64)
    v0 = np.asarray(s0.velocity)[:, idx].T.astype(np.float64)
    # one central-well step alone (XLA's fusion of force + Euler) beside
    # its device-memory bound: 7 float streams in, 7 out
    step = integrator.make_step(SimConfig(num_particles=n), donate=False)
    _, ms = _time(lambda: step(s0), 20)
    bound_ms = 14 * 4 * s0.padded_count / 3.35e12 * 1e3
    print(f"reference: central-well step @{n}: {ms:.4f} ms; HBM bound "
          f"(14 streams x 4 B at 3.35 TB/s) {bound_ms:.4f} ms", flush=True)
    del s0
    for mode in ("split", "fused"):
        d = os.path.join(out, f"reference-{mode}")
        frame_path = os.path.join(d, "frame.npy")
        args = ["-numparticles", str(n), "-steps", str(sz.steps),
                "-nogui", "-novsync", "-width", str(sz.window),
                "-height", str(sz.window), "-dumpframe", frame_path]
        if mode == "fused":
            args.append("-fused")
        m, (state, step, n_ck), wall = run_app(args, d)
        stages = m["stages_ms"]
        gauges = m["gauges"]
        print(f"reference {mode}: {wall:.1f} s for {sz.steps} frames "
              f"(incl. compile); stages_ms={stages} "
              f"frame_ms={m['frame_ms']:.3f} "
              f"pacing_allowed_in_flight="
              f"{gauges.get('pacing_allowed_in_flight')} "
              f"perf_extension_active={gauges.get('perf_extension_active')}",
              flush=True)
        for row in ("simulate", "render"):
            # the CPU's profiler trace has no device planes to time
            assert sz.rehearse or stages.get(row, 0.0) > 0.0, (
                f"{mode}: no {row} stage row")
        if mode == "split":
            # the extension compiles the compute engine's step; the fused
            # frame program has no separate compute engine to apply it to
            assert gauges.get("perf_extension_active") is True, (
                "perf extension not active on the compute engine")
        frame = np.load(frame_path)
        assert frame.shape == (sz.window, sz.window, 3), frame.shape
        assert np.isfinite(frame).all() and frame.max() > 0, "blank frame"
        pos = np.asarray(state.position)
        assert n_ck == n and np.isfinite(pos).all()
        # float64 oracle over the same number of steps. Tolerance 1e-5 of
        # each particle's radius: the device state is float32, and GPU
        # rsqrt is not correctly rounded (a few 1e-7 relative per call),
        # so each step's force carries a few 1e-7 of error into the
        # velocity; 30 damped steps stay well inside 1e-5 (the CPU's
        # float32 run lands at ~8e-7 of the radius).
        p, v = p0, v0
        for _ in range(step):
            p, v = oracle.central_well_step(p, v, dtype=np.float64)
        got = pos[:3, idx].T
        err = np.abs(got - p[:, :3]).max(axis=1)
        rel = float((err / np.linalg.norm(p[:, :3], axis=1)).max())
        print(f"reference {mode}: {step} steps, max |dr|/|r| vs float64 "
              f"oracle = {rel:.3e} (limit 1e-5)", flush=True)
        assert rel <= 1e-5, f"{mode}: oracle mismatch {rel:.3e}"


def _time(fn, reps):
    from multi_adapter_particles_tpu.utils.timers import sync

    out = fn()
    sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(out)
    return out, (time.perf_counter() - t0) * 1000.0 / reps


def phase_allpairs(jax, sz, out, sweep=False):
    import numpy as np

    from multi_adapter_particles_tpu import constants as C
    from multi_adapter_particles_tpu.models import init as pinit, integrator
    from multi_adapter_particles_tpu.ops import allpairs, dispatch

    n = sz.n_allpairs
    scale = 1.0 / n
    pos = pinit.initialize_particles_device(n, seed=42).position
    impl = dispatch.all_pairs_impl()
    kw = dict(mass=C.PARTICLE_MASS, softening_squared=C.SOFTENING_SQUARED,
              interaction_scale=scale)
    xla = jax.jit(lambda p: integrator.all_pairs_accel(p, **kw))
    results = {}
    _, ms = _time(lambda: xla(pos), 2)
    results["xla"] = ms
    if impl != dispatch.XLA:
        chosen, ms = _time(
            lambda: allpairs.all_pairs_accel_triton(pos, **kw), 3)
        results[impl] = ms
        chosen = chosen[:3]
    else:
        chosen = xla(pos)
    for name, ms in results.items():
        print(f"allpairs @{n}: {name} {ms:.3f} ms/accel, "
              f"{n * n / ms * 1e3:.4e} pairs/s", flush=True)
    if sweep and impl != dispatch.XLA:
        for bi, bj, w, st in ((64, 32, 4, 2), (128, 32, 4, 2),
                              (128, 32, 8, 2), (128, 64, 8, 2),
                              (64, 64, 4, 2), (256, 32, 8, 2),
                              (64, 32, 4, 1), (64, 32, 4, 3),
                              (32, 64, 4, 2), (128, 16, 4, 2)):
            _, ms = _time(lambda: allpairs.all_pairs_accel_triton(
                pos, block_i=bi, block_j=bj, num_warps=w, num_stages=st,
                **kw), 2)
            print(f"allpairs sweep block_i={bi} block_j={bj} warps={w} "
                  f"stages={st}: {ms:.3f} ms", flush=True)
    # float64 reference: the first n_targets targets against all sources
    p = np.asarray(pos, np.float64)[:3]
    t = np.linspace(0, n - 1, sz.n_targets).astype(np.int64)
    ref = np.zeros((3, len(t)))
    for lo in range(0, len(t), 16):
        ti = t[lo:lo + 16]
        d = p[:, None, :] - p[:, ti, None]                 # [3, 16, N]
        d2 = np.sum(d * d, axis=0) + C.SOFTENING_SQUARED
        ref[:, lo:lo + 16] = np.sum(d * d2 ** -1.5, axis=2)
    ref *= C.PARTICLE_MASS * scale
    got = np.asarray(chosen)[:, t]
    err = rms_rel(got, ref)
    print(f"allpairs @{n}: {impl} vs float64 ({len(t)} targets x all "
          f"sources) RMS rel = {err:.3e} (limit 1e-5)", flush=True)
    assert np.isfinite(got).all()
    assert err <= 1e-5, f"all-pairs mismatch {err:.3e}"


def phase_composite(jax, sz, out):
    import numpy as np

    from multi_adapter_particles_tpu.config import RenderConfig
    from multi_adapter_particles_tpu.models import init as pinit
    from multi_adapter_particles_tpu.ops import dispatch
    from multi_adapter_particles_tpu.render.camera import Camera
    from multi_adapter_particles_tpu.render.renderer import Renderer

    cfg = RenderConfig(width=sz.window, height=sz.window)
    camera = Camera(position=cfg.camera_position)
    impl = dispatch.composite_impl()
    for n in sz.n_render:
        pos = pinit.initialize_particles_device(n, seed=42).position
        frames = {}
        for name in dict.fromkeys((impl, dispatch.XLA)):
            r = Renderer(cfg, auto_raise_dup=False)
            r.composite = name
            f, ms = _time(
                lambda: r.render_arrays(pos, camera, 2.5, 0.15).frame, 5)
            frames[name] = np.asarray(f)
            print(f"composite @{n}: {name} render {ms:.3f} ms/frame",
                  flush=True)
        a, b = frames[impl], frames[dispatch.XLA]
        diff = float(np.abs(a - b).max())
        print(f"composite @{n}: max |{impl} - xla| = {diff:.3e} "
              f"(limit 1e-5)", flush=True)
        assert np.isfinite(a).all() and a.max() > 0
        assert diff <= 1e-5, f"composite mismatch {diff:.3e} at {n}"


def phase_models(jax, sz, out):
    import numpy as np

    from multi_adapter_particles_tpu.models import init as pinit
    from multi_adapter_particles_tpu.ops import p3m
    from multi_adapter_particles_tpu.ops.treeforce import host_pair_budget

    steps = 10
    m, (state, _, _), wall = run_app(
        ["-force", "pm_grid", "-numparticles", str(sz.n_pm),
         "-pmgrid", str(sz.g_pm), "-steps", str(steps), "-nogui",
         "-novsync", "-nodraw"],
        os.path.join(out, "pm_grid"))
    assert np.isfinite(np.asarray(state.position)).all()
    print(f"models: pm_grid G={sz.g_pm} @{sz.n_pm}: simulate "
          f"{m['stages_ms'].get('simulate')} ms/step (device), "
          f"{wall:.1f} s wall incl. compile", flush=True)
    assert sz.rehearse or m["stages_ms"].get("simulate", 0.0) > 0.0

    n, g, box, cut = sz.n_tree, sz.g_tree, 2048.0, 6.75
    r_c = cut * box / g
    budget = host_pair_budget(
        np.asarray(pinit.initialize_particles_device(n, seed=0).position),
        box, r_c, max(int(box // r_c), 1))
    m, (state, _, _), wall = run_app(
        ["-force", "p3m", "-p3mnear", "tree", "-numparticles", str(n),
         "-pmgrid", str(g), "-p3mbudget", str(budget), "-steps",
         str(steps), "-nogui", "-novsync", "-nodraw"],
        os.path.join(out, "p3m_tree"))
    pos = state.position
    assert np.isfinite(np.asarray(pos)).all()
    acc, dropped = p3m.p3m_accel_with_overflow(
        pos, grid=g, box=box, g_const=70000.0 / n, softening_squared=25.0,
        cutoff_cells=cut, near_mode="tree", pair_budget=budget)
    assert np.isfinite(np.asarray(acc)).all()
    print(f"models: p3m tree G={g} @{n}: simulate "
          f"{m['stages_ms'].get('simulate')} ms/step (device), "
          f"{wall:.1f} s wall incl. compile; dropped pairs on the final "
          f"state = {int(dropped)}", flush=True)
    assert int(dropped) == 0, f"tree sweep dropped {int(dropped)} pairs"
    assert sz.rehearse or m["stages_ms"].get("simulate", 0.0) > 0.0


def four_cards(jax, sz, out):
    """The two multi-device paths users run, each against one card."""
    import numpy as np

    from multi_adapter_particles_tpu import constants as C
    from multi_adapter_particles_tpu.config import RenderConfig, SimConfig
    from multi_adapter_particles_tpu.models import init as pinit, integrator
    from multi_adapter_particles_tpu.parallel import make_mesh
    from multi_adapter_particles_tpu.parallel.sharded import (
        make_sharded_step, shard_state,
    )
    from multi_adapter_particles_tpu.render.camera import Camera
    from multi_adapter_particles_tpu.render.renderer import Renderer

    devs = jax.devices()
    assert len(devs) >= 4, f"needs 4 devices, JAX sees {len(devs)}"
    print(f"four-cards: {[d.device_kind for d in devs]}", flush=True)

    # 1. the reference's namesake split: compute on card 0, render on
    # card 1, per-frame position copy — against both roles on card 0
    runs = {}
    for tag, render_ad in (("one-card", "0"), ("split", "1")):
        d = os.path.join(out, f"adapters-{tag}")
        frame = os.path.join(d, "frame.npy")
        _, (state, step, _), wall = run_app(
            ["-numparticles", str(sz.n_ref), "-steps", "10", "-nogui",
             "-novsync", "-computeadapter", "0", "-renderadapter", render_ad,
             "-width", str(sz.window), "-height", str(sz.window),
             "-dumpframe", frame], d)
        runs[tag] = (np.asarray(state.position), np.load(frame), step)
        print(f"four-cards: adapters {tag}: {wall:.1f} s wall", flush=True)
    (p1, f1, s1), (p2, f2, s2) = runs["one-card"], runs["split"]
    assert s1 == s2
    print(f"four-cards: split vs one card: positions bitwise "
          f"{np.array_equal(p1, p2)} (max diff "
          f"{float(np.abs(p1 - p2).max()):.3e}), frame bitwise "
          f"{np.array_equal(f1, f2)} (max diff "
          f"{float(np.abs(f1 - f2).max()):.3e})", flush=True)
    assert float(np.abs(p1 - p2).max()) <= 1e-5 * float(np.abs(p1).max())
    assert float(np.abs(f1 - f2).max()) <= 1e-5

    mesh = make_mesh(devs[:4])
    one = devs[0]

    # 2a. all-pairs, bit-stable all-gather schedule, against one card
    n = sz.n_mesh_allpairs
    cfg = SimConfig(num_particles=n, force_model="all_pairs")
    s0 = pinit.initialize_particles_device(n, seed=3)
    ref = integrator.make_step(cfg, donate=False)(jax.device_put(s0, one))
    got = make_sharded_step(cfg, mesh, donate=False, bit_stable=True)(
        shard_state(s0, mesh))
    dv_ref = np.asarray(ref.velocity) - np.asarray(s0.velocity)
    dv_got = np.asarray(got.velocity) - np.asarray(s0.velocity)
    err = rms_rel(dv_got[:, :n], dv_ref[:, :n])
    print(f"four-cards: mesh all-pairs @{n} (bit-stable gather) vs one "
          f"card: velocity-change RMS rel = {err:.3e} (limit 1e-5)",
          flush=True)
    assert err <= 1e-5

    # 2b. pm_grid with the slab-distributed FFT, against one card
    n = sz.n_pm
    cfg = SimConfig(num_particles=n, force_model="pm_grid",
                    pm_grid_size=sz.g_pm, pm_distributed_fft=True)
    s0 = pinit.initialize_particles_device(n, seed=4)
    ref = integrator.make_step(cfg, donate=False)(jax.device_put(s0, one))
    got = make_sharded_step(cfg, mesh, donate=False)(shard_state(s0, mesh))
    dv_ref = np.asarray(ref.velocity) - np.asarray(s0.velocity)
    dv_got = np.asarray(got.velocity) - np.asarray(s0.velocity)
    err = rms_rel(dv_got[:, :n], dv_ref[:, :n])
    # float32 FFTs of another decomposition and an all-reduced deposit:
    # reassociation only, ~1e-6 of the field
    print(f"four-cards: dist-FFT pm_grid G={sz.g_pm} @{n} vs one card: "
          f"velocity-change RMS rel = {err:.3e} (limit 1e-4)", flush=True)
    assert err <= 1e-4

    # 2c. shard-render against the gather render of the same positions
    n = sz.n_ref
    s0 = pinit.initialize_particles_device(n, seed=0)
    cfg = RenderConfig(width=sz.window, height=sz.window)
    cam = Camera(position=cfg.camera_position)
    r = Renderer(cfg, auto_raise_dup=False)
    gather = np.asarray(r.render_arrays(
        jax.device_put(s0.position, one), cam, 2.5, 0.15).frame)
    sharded = np.asarray(r.render_mesh(
        shard_state(s0, mesh).position, cam, 2.5, 0.15, mesh).frame)
    diff = float(np.abs(sharded - gather).max())
    print(f"four-cards: shard-render @{n} vs gather render: max diff "
          f"{diff:.3e} (limit 2e-3)", flush=True)
    assert gather.max() > 0 and diff <= 2e-3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths (needs 4 GPUs)")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated subset of the default phases")
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep the all-pairs kernel's launch shape")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on 4 virtual CPU devices; prints no "
                         "result line")
    ap.add_argument("--out", default=None,
                    help="directory for frames, metrics and checkpoints "
                         "(default: a temporary one, removed at exit)")
    args = ap.parse_args(argv)

    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=4").strip()
    else:
        os.environ["JAX_PLATFORMS"] = "cuda"
    sys.path.insert(0, HERE)
    import multi_adapter_particles_tpu  # noqa: F401 — fails outside the repo

    if not args.rehearse:
        print(card_line(), flush=True)
    import jax

    sz = Sizes(args.rehearse)
    out = args.out or tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        run_phases(jax, sz, args, out)
    finally:
        if args.out is None:
            shutil.rmtree(out, ignore_errors=True)
    d = jax.devices()
    if args.rehearse:
        print(f"rehearsal ok on {d[0].platform} x{len(d)}")
        return 0
    print(result_line(d[0].platform, d[0].device_kind, len(d)), flush=True)
    return 0


def run_phases(jax, sz, args, out):
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(jax, sz, out)
    else:
        for phase in args.only.split(","):
            if phase not in PHASES:
                raise SystemExit(f"unknown phase {phase!r}")
            if phase == "device" and args.rehearse:
                continue
            fn = globals()[f"phase_{phase}"]
            t1 = time.perf_counter()
            if phase == "allpairs":
                fn(jax, sz, out, sweep=args.sweep)
            else:
                fn(jax, sz, out)
            print(f"phase {phase}: ok in {time.perf_counter() - t1:.1f} s",
                  flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
