"""Per-stage device timing from windowed XLA profiler traces.

The reference's `D3D12GpuTimer` (`include/D3D12GpuTimer.h:117-160`) writes
timestamp-query pairs around each stage on the GPU queue and resolves them
to a readback buffer — per-stage times from the DEVICE clock, with zero
pipeline stalls. The JAX equivalent of the device clock is the XLA
profiler: its device planes record the on-device start and duration of
every executed kernel, attributed to its module (`jit_step`,
`jit__render`, ...), so per-stage time falls out of a short trace window
without ever synchronizing the host. JAX exposes no user-visible device
timestamps, so the profiler is the only device-clock surface — and it is
*better* than timestamp queries: every module instance is timed, not
just the two bracketing stamps.

Mechanics: every `window_every` frames the timer traces `window_frames`
frames into a temp dir, then parses the xplane in a background thread.
Tracing costs host time while a window is open, so the default duty cycle
is 2 frames every 128, and `-timerwindow` tightens it when a run wants
fresher rows.
Stage time per frame = sum of matching module durations / number of
executions (count-normalization makes window edges harmless — a module's
event is attributed whether or not the host dispatched it inside the
window). Results land on the usual "simulate ms" / "render ms"
`StageTimer` rows with the reference's EMA(1/20) smoothing
(`D3D12GpuTimer.h:133-160` GetTimes averaging).
"""

from __future__ import annotations

import glob
import os
import shutil
import tempfile
import threading
from typing import Dict, Optional, Sequence, Tuple

from multi_adapter_particles_tpu.utils.metrics import MetricsRegistry

# module-name substring -> stage row. The jitted callables are named by
# their Python function: integrator/sharded steps are `step`/`sharded_step`
# variants; the splatter's program is `_render`; the fused frame is `fused`.
DEFAULT_STAGE_PATTERNS: Dict[str, Tuple[str, ...]] = {
    "simulate": ("step",),
    "render": ("_render",),
    "frame": ("fused",),
}

# Fused-mode stage markers (see runtime/fused.py stage_markers): the
# frame program broadcasts a scalar to [1, STAGE_BEGIN_COLS] before its
# render stage and its render anchor to [1, STAGE_MARKER_COLS] between
# render and sim. XLA launches each broadcast as one block of that many
# threads, which the kernel's kernel_details stat names; 59 and 61 never
# occur as natural widths here (frame widths are multiples of 16, state
# rows are 3/4-wide).
STAGE_BEGIN_COLS = 59
STAGE_MARKER_COLS = 61
_BEGIN_TOKEN = f"block:{STAGE_BEGIN_COLS},1,1"
_MARKER_TOKEN = f"block:{STAGE_MARKER_COLS},1,1"


def _kernel_view(plane):
    """A GPU device plane holds one event per kernel or copy on its stream
    lines, tagged with the `hlo_module` it ran for. Regroup them ->
    {module: [(start_ns, dur_ns, scope, text)]} in start order, for
    run-time events only (autotuning during compilation is tagged
    `XlaCompile` and belongs to no frame). `text` is the event name plus
    its kernel_details, which is what the marker search reads."""
    mods: Dict[str, list] = {}
    for line in plane.lines:
        for ev in line.events:
            st = dict(ev.stats)
            mod = st.get("hlo_module")
            dur = getattr(ev, "duration_ns", None)
            if (not mod or dur is None
                    or "XlaCompile" in str(st.get("tf_op", ""))):
                continue
            mods.setdefault(str(mod), []).append((
                ev.start_ns, dur, st.get("scope_range_id"),
                f"{ev.name} {st.get('kernel_details', '')}",
            ))
    for events in mods.values():
        events.sort(key=lambda e: e[0])
    return mods


def _executions(events) -> int:
    """Executions of one module in a window: every execution launches the
    same kernels, so the least frequent kernel name counts them (a loop
    body's kernels repeat within one execution, its prologue's do not)."""
    names: Dict[str, int] = {}
    for _s, _d, _scope, text in events:
        key = text.split(" ", 1)[0]
        names[key] = names.get(key, 0) + 1
    return min(names.values()) if names else 0


def parse_stage_ms(
    profile_data,
    stage_patterns: Dict[str, Tuple[str, ...]] = DEFAULT_STAGE_PATTERNS,
) -> Dict[str, float]:
    """Per-FRAME stage milliseconds from a ProfileData xspace.

    Walks the kernel events of every GPU device plane (`_kernel_view`);
    for each stage, sums the device time of the kernels of modules whose
    name contains any pattern. The per-frame normalizer is the execution
    count (`_executions`) of a once-per-frame anchor stage (simulate, or
    the fused frame) when one is present — a stage may legitimately
    dispatch SEVERAL modules per frame (the chunked renderer issues one
    `_render` per chunk; dividing by its own count would under-report a
    16.8M render 4x) — falling back to the stage's own count
    (render-only traces).

    Fused mode (the reference shows per-stage times in BOTH modes,
    `Particles.cpp:399-409`): the one `fused` module's kernels, in time
    order, split at the two stage markers the frame program plants
    (`FusedEngine stage_markers`): from a start marker to the next
    boundary marker is the render stage, from there to the next start
    marker the sim stage. Kernels before the window's first start marker
    belong to a frame the window cut, and count for no row. Those land
    on the same "render"/"simulate" rows, per frame; the frame row is
    the module's time over its start markers.
    """
    totals: Dict[str, float] = {}
    counts: Dict[str, int] = {}

    def add(stage, ns, n):
        totals[stage] = totals.get(stage, 0.0) + ns
        counts[stage] = counts.get(stage, 0) + n

    for plane in profile_data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for mod, events in _kernel_view(plane).items():
            stage = next(
                (st for st, pats in stage_patterns.items()
                 if any(p in mod for p in pats)),
                None,
            )
            if stage is None:
                continue
            starts = sum(_BEGIN_TOKEN in e[3] for e in events)
            if stage != "frame" or not starts:
                # markers off: module-level rows only
                add(stage, sum(e[1] for e in events), _executions(events))
                continue
            add("frame", 0.0, starts)
            row = None  # None until the window's first start marker
            for _s, d, _sc, text in events:
                if _BEGIN_TOKEN in text:
                    row = "render"
                    add("render", 0.0, 1)
                elif _MARKER_TOKEN in text and row is not None:
                    row = "simulate"
                    add("simulate", 0.0, 1)
                elif row is not None:
                    add(row, d, 0)
                    add("frame", d, 0)
    # frame count: prefer the module-level count ("frame" = one fused
    # execution each; in split mode it is absent and the per-module
    # "simulate" count is the frame count). NOT the marker-split sample
    # count — a window-edge-truncated marker drops a simulate/render
    # sample without dropping the module event, and dividing by the
    # smaller count would inflate the frame row's k-multiplier.
    frames = counts.get("frame") or counts.get("simulate")
    out: Dict[str, float] = {}
    for stage in totals:
        c = counts.get(stage)
        if not c:
            continue
        # per-frame dispatch multiplicity (1 for once-per-frame stages;
        # the chunk count for chunked renders); window edges round away
        k = max(1, round(c / frames)) if frames else 1
        out[stage] = (totals[stage] / c * k) / 1e6
    return out


class ProfilerStageTimer:
    """Windowed device-plane stage timing (the D3D12GpuTimer role)."""

    def __init__(
        self,
        metrics: Optional[MetricsRegistry] = None,
        stage_patterns: Optional[Dict[str, Tuple[str, ...]]] = None,
        window_every: int = 128,
        window_frames: int = 2,
        first_window: int = 8,
    ):
        """`first_window`: frame of the FIRST trace window. The reference
        times every frame (`D3D12GpuTimer.h:117-160`); an early first
        window (post-compile, default frame 8) makes short runs and demos
        record stage rows too — round 2's 64-frame-aligned duty cycle left
        any run under ~60 frames with empty stages_ms."""
        self.metrics = metrics or MetricsRegistry()
        self.stage_patterns = stage_patterns or dict(DEFAULT_STAGE_PATTERNS)
        self.window_every = max(int(window_every), int(window_frames) + 1)
        self.window_frames = max(1, int(window_frames))
        self._next_window = max(1, int(first_window))
        self._active_since: Optional[int] = None
        self._log_dir: Optional[str] = None
        self._parsers: list = []
        self._disabled = False
        self.windows_parsed = 0

    # -- frame hook (call once at the top of every frame) --------------------
    def on_frame(self, frame_count: int) -> None:
        if self._disabled:
            return
        if self._active_since is not None:
            if frame_count - self._active_since >= self.window_frames:
                self._stop_and_parse()
            return
        if frame_count >= self._next_window:
            self._next_window = frame_count + self.window_every
            self._start(frame_count)

    def _start(self, frame_count: int) -> None:
        import jax

        self._log_dir = tempfile.mkdtemp(prefix="map_tpu_gputimer_")
        try:
            try:
                # only the device planes matter: skip python/host tracing
                opts = jax.profiler.ProfileOptions()
                opts.python_tracer_level = 0
                opts.host_tracer_level = 0
                jax.profiler.start_trace(self._log_dir, profiler_options=opts)
            except TypeError:  # older start_trace signature
                jax.profiler.start_trace(self._log_dir)
        except Exception:
            # another trace is active (e.g. the CLI -trace flag) or the
            # backend can't profile: stand down for the whole run
            self._disabled = True
            shutil.rmtree(self._log_dir, ignore_errors=True)
            self._log_dir = None
            return
        self._active_since = frame_count

    def _stop_and_parse(self) -> None:
        import jax

        try:
            jax.profiler.stop_trace()
        except Exception:
            self._disabled = True
            return
        finally:
            self._active_since = None
        log_dir, self._log_dir = self._log_dir, None
        t = threading.Thread(
            target=self._parse, args=(log_dir,), daemon=True,
            name="gputimer-parse",
        )
        t.start()
        self._parsers.append(t)

    def _parse(self, log_dir: str) -> None:
        try:
            from jax.profiler import ProfileData

            paths = glob.glob(
                os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True
            )
            if not paths:
                return
            stage_ms = parse_stage_ms(
                ProfileData.from_file(paths[0]), self.stage_patterns
            )
            for stage, ms in stage_ms.items():
                self.metrics.stage(stage).add_sample(ms / 1e3)
            if stage_ms:
                self.windows_parsed += 1
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)

    def flush(self) -> None:
        """Finish any open window and wait for pending parses."""
        if self._active_since is not None:
            self._stop_and_parse()
        for t in self._parsers:
            t.join(timeout=30.0)
        self._parsers = [t for t in self._parsers if t.is_alive()]

    def close(self) -> None:
        self.flush()
