"""Headless CLI application — WinMain + message pump analog.

Flag set tracks the reference (`Particles.cpp:251-267`): numparticles,
nogui, noext, size, intensity, novsync, fullscreen, numCopy, numDraw,
numSim; `?` prints help (`ArgParser.h:105-127`). Extensions beyond the
reference: steps, seed, force model, adapter indices, frame dumping, metrics JSON.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from multi_adapter_particles_tpu.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_tpu.utils.argparser import ArgParser


def build_parser(app: AppConfig, extra: dict) -> ArgParser:
    p = ArgParser("multi_adapter_particles_tpu — JAX particle sim + render")

    def set_attr(name):
        return lambda v: setattr(app, name, v)

    p.add_int("numparticles", "number of particles", set_attr("num_particles"))
    p.add_float("size", "particle size", set_attr("particle_size"))
    p.add_float("intensity", "particle sprite intensity", set_attr("particle_intensity"))
    p.add_flag("nogui", "disable the dashboard overlay",
               lambda: setattr(app, "gui", False))
    p.add_flag("novsync", "disable frame pacing",
               lambda: setattr(app, "vsync", False))
    p.add_flag("fullscreen",
               "borderless fullscreen: render at the fullscreen resolution "
               "(RenderConfig.fullscreen_width/height, default 1920x1080)",
               lambda: setattr(app, "fullscreen", True))
    p.add_flag("noext", "disable the queue-throttle extension analog",
               lambda: setattr(app, "use_queue_extension", False))
    p.add_int("framelatency",
              "max frames in flight under -novsync (SetMaximumFrameLatency)",
              set_attr("max_frame_latency"))

    def unlink_and_set(name):
        def h(v):
            app.linked = False
            setattr(app, name, v)
        return h

    p.add_int("numsim", "# particles simulated per frame", unlink_and_set("num_sim"))
    p.add_int("numcopy", "# particles transferred per frame", unlink_and_set("num_copy"))
    p.add_int("numdraw", "# particles drawn per frame", unlink_and_set("num_draw"))

    # extensions beyond the reference
    def preset(name):
        from multi_adapter_particles_tpu.presets import apply_preset

        apply_preset(name, app, extra)

    p.add_str("preset", "named benchmark config (see presets.py)", preset)
    p.add_int("steps", "number of frames to run (0 = forever)",
              lambda v: extra.__setitem__("steps", v))
    p.add_int("seed", "init RNG seed", lambda v: extra.__setitem__("seed", v))
    p.add_str("force", "force model: central_well | all_pairs | pm_grid | p3m",
              lambda v: extra.__setitem__("force", v))
    p.add_float("interactionscale",
                "per-pair force multiplier (default: auto — 1/N for the "
                "self-gravity models, keeping the total mass at the "
                "central-well value; 1.0 for central_well)",
                lambda v: extra.__setitem__("interaction_scale", v))
    p.add_int("pmgrid", "pm_grid/p3m mesh resolution per axis (omit with "
              "-p3mnear tree: a scene-probed cost model picks it)",
              lambda v: extra.__setitem__("pm_grid_size", v))
    p.add_float("pmbox", "pm_grid/p3m box extent (world units)",
                lambda v: extra.__setitem__("pm_box", v))
    p.add_float("p3mcutoff", "p3m short-range cutoff in mesh cells",
                lambda v: extra.__setitem__("p3m_cutoff_cells", v))
    p.add_int("p3mcapacity", "p3m near-cell particle capacity",
              lambda v: extra.__setitem__("p3m_capacity", v))
    p.add_str("p3mnear",
              "p3m near-field engine: auto | slots | tree (auto probes the "
              "initial state and picks tree when the slot capacity would "
              "overflow — e.g. the demo's cluster cores)",
              lambda v: extra.__setitem__("p3m_near_mode", v))
    p.add_int("p3mbudget",
              "tree near-field block-pair budget (default: sized from the "
              "initial state)",
              lambda v: extra.__setitem__("p3m_pair_budget", v))
    p.add_str("probecache",
              "startup-probe sidecar: auto (default, ~/.cache/"
              "multi_adapter_particles_tpu/probes.json) | off | a path — "
              "repeat launches of the same (N, seed, box, cutoff) skip "
              "the host tree probes (~66 s at 4M)",
              lambda v: extra.__setitem__("probe_cache", v))
    p.add_str("compilecache",
              "persistent XLA compilation cache: auto (default: "
              "$JAX_COMPILATION_CACHE_DIR if set, else .jax_cache/ in "
              "the checkout) | off | a dir — warm launches fetch "
              "compiled programs instead of recompiling",
              lambda v: extra.__setitem__("compile_cache", v))
    p.add_int("meshdevices", "run compute on a mesh of N devices (sharded sim)",
              lambda v: extra.__setitem__("mesh_devices", v))
    p.add_flag("shardrender", "with -meshdevices: shard the RENDER role "
               "over the mesh too (image-pair gather replaces the "
               "position copy)",
               lambda: extra.__setitem__("shard_render", True))
    p.add_int("computeadapter", "compute adapter index",
              lambda v: extra.__setitem__("compute_adapter", v))
    p.add_int("renderadapter", "render adapter index",
              lambda v: extra.__setitem__("render_adapter", v))
    p.add_int("width", "frame width", lambda v: extra.__setitem__("width", v))
    p.add_int("height", "frame height", lambda v: extra.__setitem__("height", v))
    p.add_str("dumpframe", "write the final frame to this .png/.npy path",
              lambda v: extra.__setitem__("dumpframe", v))
    p.add_flag("u8frame", "render to RGB8 on device (swap-chain UNORM "
               "format analog; 4x cheaper frame pulls)",
               lambda: extra.__setitem__("frame_uint8", True))
    p.add_str("metrics", "write metrics JSON to this path",
              lambda v: extra.__setitem__("metrics", v))
    p.add_int("profileevery", "hard-sync stage timing every K frames",
              lambda v: extra.__setitem__("profile_every", v))
    p.add_int("diagnostics",
              "conservation gauges (energy/momentum/angular momentum + "
              "energy drift) every K frames; the self-gravity potential "
              "is the exact O(N^2) pairwise sum up to 262K particles and "
              "the P3M-split mesh gauge above (usable at the 4M default; "
              "-diagmode overrides)",
              lambda v: extra.__setitem__("diag_every", v))
    p.add_str("diagmode",
              "diagnostics potential: auto (default; exact <=262K, mesh "
              "above), exact (O(N^2) sum at any N — a ~94 s dispatch at "
              "4M), mesh (P3M-split gauge, ~1e-4 of exact)",
              lambda v: extra.__setitem__("diag_mode", v))
    p.add_int("timerwindow",
              "device stage-timer trace cadence in frames (first window "
              "always fires early, at frame 8)",
              lambda v: extra.__setitem__("timer_window_every", v))
    p.add_flag("nodraw", "simulate only (SPACE-toggle analog)",
               lambda: extra.__setitem__("draw", False))
    p.add_flag("interactive",
               "read keys: SPACE toggles draw, ESC/q quits, WASD/arrows "
               "fly, mouse drag looks (xterm SGR reporting)",
               lambda: extra.__setitem__("interactive", True))
    p.add_flag("fused", "sim+render as one compiled program (async-compute "
               "analog; single device only)",
               lambda: extra.__setitem__("fused", True))
    p.add_flag("debug", "validation layer: NaN checks, no donation, "
               "hand-off asserts (D3D12 debug layer analog)",
               lambda: extra.__setitem__("debug", True))
    p.add_str("trace", "write a jax profiler trace to this directory",
              lambda v: extra.__setitem__("trace", v))
    p.add_flag("listadapters", "print the adapter list and exit",
               lambda: extra.__setitem__("list_adapters", True))
    p.add_str("dashboard", "write a live HTML dashboard to this path",
              lambda v: extra.__setitem__("dashboard", v))
    p.add_int("serve", "serve the LIVE bidirectional dashboard on this "
              "port (0 = pick one); widgets drive the app like the GUI",
              lambda v: extra.__setitem__("serve", v))
    p.add_str("checkpoint", "write a state checkpoint here at exit (.npz)",
              lambda v: extra.__setitem__("checkpoint", v))
    p.add_int("checkpointevery", "also checkpoint every K frames",
              lambda v: extra.__setitem__("checkpoint_every", v))
    p.add_str("resume", "resume state from a checkpoint (.npz)",
              lambda v: extra.__setitem__("resume", v))
    return p


def write_frame(frame, path: str) -> None:
    import numpy as np

    arr = np.asarray(frame)
    if path.endswith(".npy"):
        np.save(path, arr)
        return
    from multi_adapter_particles_tpu.utils.png import write_png

    write_png(path, arr)


def main(argv: Optional[List[str]] = None) -> int:
    app_cfg = AppConfig()
    extra: dict = {}
    parser = build_parser(app_cfg, extra)
    unmatched = parser.parse(argv)
    if unmatched:
        print(f"warning: unmatched args {unmatched}", file=sys.stderr)

    # Heavy imports after flag parsing so `-?` is instant.
    from multi_adapter_particles_tpu.runtime.orchestrator import ParticlesApp
    from multi_adapter_particles_tpu.runtime.devices import enumerate_adapters
    from multi_adapter_particles_tpu.utils import compilecache

    # Persistent XLA compilation cache (the runtime-shader-compile
    # analog made warm-startable): on by default, like -probecache.
    compilecache.enable(extra.get("compile_cache", "auto"))

    if extra.get("list_adapters"):
        for a in enumerate_adapters():
            print(f"[{a.index}] {a.platform:4s} {a.description}")
        return 0

    near_mode = extra.get("p3m_near_mode", "auto")
    pair_budget = extra.get("p3m_pair_budget")
    if extra.get("force") == "p3m" and (
        near_mode == "auto"
        or (
            near_mode == "tree"
            and (
                # every probe-derived value is gated individually below,
                # so enter whenever ANY is missing: an explicit
                # -p3mbudget must not silently disable the auto grid (and
                # vice versa); supplying both skips the probe entirely
                "pm_grid_size" not in extra
                or pair_budget is None
            )
        )
    ):
        # Probe the initial state host-side: if the slot sweep's capacity
        # would overflow (the demo's cluster cores), run the tree near
        # field instead — exact on any density contrast (ops/treeforce.py)
        # — and size its block-pair budget from the actual scene.
        # Probe results persist in a JSON sidecar keyed by the scene
        # identity (N, seed, box, cutoff — the device init is
        # deterministic in N and seed), so a REPEAT launch of the same
        # config skips every host sort and the device init feeding them
        # (~15-25 s per candidate probe at 4M; -probecache off disables;
        # utils/probecache.py).
        from multi_adapter_particles_tpu.models import init as pinit
        from multi_adapter_particles_tpu.ops.p3m import host_overflow_count
        from multi_adapter_particles_tpu.ops.treeforce import (
            counts_cache_key,
            host_tree_counts,
        )
        from multi_adapter_particles_tpu.utils.probecache import open_cache

        import numpy as np

        grid = extra.get("pm_grid_size", SimConfig.pm_grid_size)
        box = extra.get("pm_box", SimConfig.pm_box)
        cutoff = extra.get("p3m_cutoff_cells", SimConfig.p3m_cutoff_cells)
        cache = open_cache(
            extra.get("probe_cache"), app_cfg.num_particles,
            extra.get("seed", 0), box, cutoff,
        )

        # Probe the DEVICE init: it is the scene the engines actually
        # start from (same seed), and it is compiled — the host oracle
        # tiers are per-particle Python (~130 us/particle: 9 min at 4M,
        # measured) and draw a DIFFERENT stream anyway. Materialized
        # LAZILY: a warm cache needs no positions at all.
        _pos0 = [None]

        def pos0():
            if _pos0[0] is None:
                _pos0[0] = np.asarray(
                    pinit.initialize_particles_device(
                        app_cfg.num_particles, seed=extra.get("seed", 0)
                    ).position
                )  # [4, Np]; padding parked at 1e9 = out-of-box, ignored
            return _pos0[0]

        if near_mode == "auto":
            cap = extra.get("p3m_capacity", SimConfig.p3m_capacity)
            ov = cache.overflow.get((grid, cap))
            if ov is None:
                ov = host_overflow_count(pos0(), grid, box, cutoff, cap)
                cache.overflow[(grid, cap)] = int(ov)
            near_mode = "tree" if ov else "slots"
            print(
                f"p3m: near-field auto probe -> {near_mode}"
                + (
                    f" ({ov} particles would overflow the slot capacity)"
                    if ov
                    else " (slot capacity covers the scene)"
                ),
                flush=True,
            )
        if near_mode == "tree" and "pm_grid_size" not in extra:
            # no explicit -pmgrid: pick the mesh from the measured cost
            # model (the optimum shifts with the scene/N — 128 @262K but
            # 192 @1M on the demo init; ops/treeforce.py auto_grid)
            from multi_adapter_particles_tpu.ops.treeforce import auto_grid

            grid = auto_grid(
                pos0, box, cutoff, counts_cache=cache.counts,
                num_particles=app_cfg.num_particles,
            )
            extra["pm_grid_size"] = grid
            print(f"p3m: tree grid auto-selected G={grid} "
                  "(scene-probed cost model; override with -pmgrid)",
                  flush=True)
        if near_mode == "tree" and pair_budget is None:
            # auto_grid above already cached this grid's counts, so the
            # probe is usually free
            from multi_adapter_particles_tpu.ops.treeforce import (
                PAIR_HEADROOM,
            )

            r_c = cutoff * box / grid
            gn = max(int(box // r_c), 1)
            ck = counts_cache_key(gn, r_c)
            if ck in cache.counts:
                count, _block = cache.counts[ck]
            else:
                count, _block = host_tree_counts(pos0(), box, r_c, gn)
                cache.counts[ck] = (count, _block)
            pair_budget = int(count * PAIR_HEADROOM) + 1
            print(f"p3m: tree pair budget sized to {pair_budget} "
                  "(from the initial state)", flush=True)
        cache.save()

    sim_cfg = SimConfig(
        num_particles=app_cfg.num_particles,
        force_model=extra.get("force", "central_well"),
        # None = auto: 1.0 for central_well, 1/N for the self-gravity
        # models (keeps total mass at the central-well value; forgetting
        # the manual 1/N used to change the physics by ~1e6x)
        interaction_scale=extra.get("interaction_scale"),
        pm_grid_size=extra.get("pm_grid_size", SimConfig.pm_grid_size),
        pm_box=extra.get("pm_box", SimConfig.pm_box),
        p3m_cutoff_cells=extra.get(
            "p3m_cutoff_cells", SimConfig.p3m_cutoff_cells
        ),
        p3m_capacity=extra.get("p3m_capacity", SimConfig.p3m_capacity),
        p3m_near_mode=near_mode,
        p3m_pair_budget=pair_budget,
    )
    render_cfg = RenderConfig(
        width=extra.get("width", RenderConfig.width),
        height=extra.get("height", RenderConfig.height),
        frame_uint8=extra.get("frame_uint8", False),
    )
    steps = extra.get("steps", 600)
    # Default stage timing is the non-stalling AsyncStageProbe (gui runs);
    # -profileevery opts into precise hard-sync windows instead.
    profile_every = extra.get("profile_every", 0)

    particles = ParticlesApp(
        app_cfg,
        sim_cfg,
        render_cfg,
        compute_adapter=extra.get("compute_adapter"),
        render_adapter=extra.get("render_adapter"),
        seed=extra.get("seed", 0),
        draw_enabled=extra.get("draw", True),
        profile_every=profile_every,
        mesh_devices=extra.get("mesh_devices", 0),
        debug=extra.get("debug", False),
        fused=extra.get("fused", False),
        shard_render=extra.get("shard_render", False),
        timer_window_every=extra.get("timer_window_every", 128),
        # a -metrics dump with empty stage rows is useless: force the
        # non-stalling device-clock timer on even for -nogui/preset runs
        # (it costs one 4-frame trace window per 64 frames)
        async_timers=True if "metrics" in extra else None,
    )

    if sim_cfg.force_model == "p3m" and sim_cfg.p3m_near_mode == "slots":
        # near-field coverage on the initial state: overflowing particles
        # keep the smooth mesh force only (host-side count, no compiles)
        from multi_adapter_particles_tpu.ops.p3m import host_overflow_count

        ov = host_overflow_count(
            particles.compute.positions, sim_cfg.pm_grid_size,
            sim_cfg.pm_box, sim_cfg.p3m_cutoff_cells, sim_cfg.p3m_capacity,
        )
        if ov:
            print(
                f"p3m: {ov} of {sim_cfg.num_particles} particles exceed "
                f"near-cell capacity {sim_cfg.p3m_capacity} — they keep "
                "only the smooth long-range mesh force (WORSE than pure "
                "pm_grid at small separations). Use -p3mnear tree (exact "
                "on any density contrast), raise -p3mcapacity / -pmgrid, "
                "or prefer -force pm_grid for this scene.",
                flush=True,
            )

    if "resume" in extra:
        from multi_adapter_particles_tpu.utils.checkpoint import load_checkpoint

        state, step, ckpt_n = load_checkpoint(extra["resume"])
        if ckpt_n != app_cfg.num_particles:
            print(
                f"error: checkpoint has {ckpt_n} particles but "
                f"-numparticles is {app_cfg.num_particles}; pass "
                f"-numparticles {ckpt_n} to resume",
                file=sys.stderr,
            )
            return 2
        particles.compute.restore(state)
        particles.compute.step_count = step
        particles.share_handles()

    ckpt_every = extra.get("checkpoint_every", 0)

    diag = None
    if extra.get("diag_every"):
        from multi_adapter_particles_tpu.models.diagnostics import (
            DiagnosticsProbe,
        )

        diag = DiagnosticsProbe(
            sim_cfg, extra["diag_every"],
            potential_mode=extra.get("diag_mode", "auto"),
        )

    server = None
    if "serve" in extra:
        from multi_adapter_particles_tpu.utils.dashboard import DashboardServer

        server = DashboardServer(particles, port=extra["serve"])
        print(f"dashboard: http://127.0.0.1:{server.port}/", flush=True)

    def overlay(p: ParticlesApp):
        if diag is not None:
            # one host sync per sample (float() pulls the scalars) — the
            # cadence keeps it off the hot path, like -checkpointevery
            diag.maybe_publish(p.frame_count, p.compute.state, p.metrics)
        if server is not None:
            server.drain()
            # live viewer: push the frame to any connected /stream client
            # (free when none; rate-limited inside)
            server.publish_frame(p.render.last_frame)
        if app_cfg.gui and p.frame_count % 30 == 0:
            print(f"--- frame {p.frame_count} ---")
            print(p.metrics.render_text())
        if "dashboard" in extra and p.frame_count % 30 == 0:
            from multi_adapter_particles_tpu.utils import dashboard

            dashboard.write_html(
                p, extra["dashboard"], frame=p.render.last_frame
            )
        if ckpt_every and "checkpoint" in extra and p.frame_count % ckpt_every == 0:
            from multi_adapter_particles_tpu.utils.checkpoint import save_checkpoint

            save_checkpoint(
                extra["checkpoint"], p.compute.state,
                p.compute.get_fence_value(), app_cfg.num_particles,
            )

    target_fps = 60.0 if app_cfg.vsync else None
    import contextlib

    ctx = contextlib.ExitStack()
    if extra.get("debug"):
        from multi_adapter_particles_tpu.utils.debug import debug_mode

        ctx.enter_context(debug_mode())
    if "trace" in extra:
        import jax

        jax.profiler.start_trace(extra["trace"])
        ctx.callback(jax.profiler.stop_trace)
    try:
        if extra.get("interactive"):
            from multi_adapter_particles_tpu.runtime.input import TerminalInput

            with TerminalInput() as ti:
                frames = 0
                while steps <= 0 or frames < steps:
                    inp = ti.poll()
                    if inp.quit:
                        break
                    if inp.toggle_draw:
                        particles.draw_enabled = not particles.draw_enabled
                    # the full control panel on keys (runtime/controls.py):
                    # adapters, size/intensity, counts + link, toggles
                    from multi_adapter_particles_tpu.runtime.controls import (
                        apply_key,
                    )

                    for key in inp.pressed:
                        msg = apply_key(particles, key)
                        if msg and app_cfg.gui:
                            print(msg)
                    if inp.mouse_dx or inp.mouse_dy:
                        particles.render.camera.drag(
                            inp.mouse_dx, inp.mouse_dy
                        )
                    for key in inp.pressed:
                        particles.render.camera.key_down(key)
                    particles.draw()
                    particles.render.camera.update(
                        particles.metrics.frame_timer.average
                    )
                    for key in inp.pressed:
                        particles.render.camera.key_up(key)
                    overlay(particles)
                    frames += 1
        elif steps <= 0:
            while True:
                particles.draw()
                overlay(particles)
        else:
            particles.run(steps, frame_callback=overlay, target_fps=target_fps)
    except KeyboardInterrupt:
        pass
    finally:
        ctx.close()
        if server is not None:
            server.close()
    # run-level state for the metrics dump: whether the perf extension
    # compiled the step, and the pacing bound the frame loop ended with
    ext = particles.extension
    particles.metrics.gauge(
        "perf_extension_active", bool(ext is not None and ext.active)
    )
    particles.metrics.gauge(
        "pacing_allowed_in_flight", particles.pacing.allowed_in_flight
    )
    particles.shutdown()

    print(particles.metrics.render_text())
    if "dashboard" in extra:
        from multi_adapter_particles_tpu.utils import dashboard

        dashboard.write_html(
            particles, extra["dashboard"], frame=particles.render.last_frame
        )
    if "checkpoint" in extra:
        from multi_adapter_particles_tpu.utils.checkpoint import save_checkpoint

        save_checkpoint(
            extra["checkpoint"], particles.compute.state,
            particles.compute.get_fence_value(), app_cfg.num_particles,
        )
    if "dumpframe" in extra and particles.render.last_frame is not None:
        write_frame(particles.render.last_frame, extra["dumpframe"])
    if "metrics" in extra:
        with open(extra["metrics"], "w") as f:
            f.write(json.dumps(particles.metrics.as_dict(), indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
