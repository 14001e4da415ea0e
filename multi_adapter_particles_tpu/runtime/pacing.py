"""Frame pacing: the latency-waitable swap chain analog.

`FrameLatencyQueue` reproduces `SetMaximumFrameLatency`
(`Render.cpp:298-308`; wait handle consumed in `UpdateCamera`,
`Render.cpp:763-767`): the frame loop may dispatch ahead, but never more
than `max_latency` unconfirmed frames. Each dispatched frame contributes a
tiny async "fence marker" (a 1-element slice of the frame's output,
enqueued before any later donation can retire the buffer). A waiter thread
confirms completions off the critical path: it blocks on the NEWEST
pending marker (device streams are FIFO, so that confirms every older
frame too — one host round-trip covers the whole backlog) and wakes the
frame loop, which only sleeps when the in-flight estimate exceeds the
bound.

Transport compensation: where a completion becomes VISIBLE to the host
only one transport round-trip after it happens, `dispatched - confirmed`
overestimates the device queue by rtt/frame_time frames and the loop
stalls while the device sits idle. The waiter therefore estimates the
round-trip (minimum observed confirmation wait — a wait on an
already-complete marker is exactly one RTT) and runs a control loop on
the wait slack: confirmation waits that return in ~one RTT mean the device
had already drained the backlog (grow the window, multiplicatively);
waits well beyond one RTT mean the device is genuinely busy (shrink
back). The DEVICE in-flight depth stays bounded near `max_latency` — the
reference's actual semantic. It is OFF by default: on a local GPU every
confirmation wait is a wait for queued device work, never a transport
round-trip, so the estimate reads a busy device as transport lag and
grows the window (measured on an H100: 18 frames allowed in flight at
the 4M frame instead of 2). Removing it is ROADMAP D6.

Per-stage device timing lives in `runtime/gputimer.py` (profiler-plane
based): marker completions resolve whole frames, not the stages inside
one, so stage timing uses the XLA profiler's device clock instead.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from multi_adapter_particles_tpu.utils.timers import sync


def fence_marker(x):
    """A tiny async slice depending on `x`'s completion.

    Enqueued on the main thread immediately, so it is ordered BEFORE any
    later donating dispatch that would retire `x` itself; blocking on the
    marker later is therefore always safe and waits for the producing
    program of `x` (single FIFO stream per device).
    """
    return x[tuple(slice(0, 1) for _ in range(x.ndim))]


class FrameLatencyQueue:
    """Bounded in-flight frame depth (SetMaximumFrameLatency analog)."""

    def __init__(
        self,
        max_latency: int = 2,
        transport_compensation: bool = False,
        max_extra: int = 16,
    ):
        self.max_latency = max(1, int(max_latency))
        self.transport_compensation = transport_compensation
        self.max_extra = max(0, int(max_extra))
        self._cond = threading.Condition()
        self._pending: deque = deque()  # (seq, marker), FIFO
        self._seq = 0
        self._confirmed = 0
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # transport estimates (guarded by _cond)
        self._rtt_samples: deque = deque(maxlen=16)   # sync wait seconds
        self._extra = 0                               # transport slack frames

    def __len__(self) -> int:
        """Frames dispatched but not yet confirmed complete."""
        with self._cond:
            return self._seq - self._confirmed

    # -- transport-aware bound (call with _cond held) -------------------------
    def _allowed(self) -> int:
        if not self.transport_compensation or not self._rtt_samples:
            return self.max_latency
        if min(self._rtt_samples) < 0.002:
            # local-transport round-trips are microseconds: no limbo to
            # compensate, keep the reference bound exactly
            return self.max_latency
        return self.max_latency + self._extra

    @property
    def allowed_in_flight(self) -> int:
        """Current unconfirmed-frame bound (max_latency + transport slack)."""
        with self._cond:
            return self._allowed()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._closed = False
            self._thread = threading.Thread(
                target=self._run, name="frame-latency-waiter", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending and self._closed:
                    return
                # Confirm the whole backlog with ONE wait: FIFO execution
                # means the newest marker completing implies all older ones.
                seq, marker = self._pending[-1]
                self._pending.clear()
            t0 = time.perf_counter()
            try:
                sync(marker)
            except Exception:  # noqa: BLE001 — a failed wait must not
                # leave `drain()` spinning forever; count the batch as
                # confirmed and let the error surface on the main
                # thread's next real sync of the same stream
                pass
            t1 = time.perf_counter()
            with self._cond:
                self._confirmed = max(self._confirmed, seq)
                # rtt: a wait on an ALREADY-complete marker is exactly one
                # transport round-trip; the min over recent waits converges
                # to it. Control loop on the slack: a wait ~= rtt means the
                # device had finished the whole backlog before we even
                # asked — it is being starved by visibility lag, so grow
                # the window (multiplicative, to converge within a few
                # cycles); a wait >> rtt means the device is genuinely
                # busy — shrink back toward the reference bound.
                wait = t1 - t0
                self._rtt_samples.append(wait)
                rtt = min(self._rtt_samples)
                if rtt >= 0.002:
                    if wait <= rtt * 1.2 + 0.001:
                        self._extra = min(
                            max(2 * self._extra, 2), self.max_extra
                        )
                    elif wait > rtt * 2.0:
                        self._extra = max(self._extra - 1, 0)
                self._cond.notify_all()

    def push(self, frame_output) -> None:
        """Register a just-dispatched frame; block only while more than
        the allowed in-flight bound remains unconfirmed."""
        marker = fence_marker(frame_output)
        self._ensure_thread()
        with self._cond:
            self._seq += 1
            self._pending.append((self._seq, marker))
            self._cond.notify_all()
            while self._seq - self._confirmed > self._allowed():
                self._cond.wait()

    def drain(self) -> None:
        """Block until every registered frame has been confirmed."""
        with self._cond:
            while self._confirmed < self._seq:
                self._cond.notify_all()
                self._cond.wait(timeout=0.1)

    def close(self) -> None:
        self.drain()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
