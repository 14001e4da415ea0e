"""Performance-extension layer — the ExtensionHelper analog.

The reference probes for Intel's driver extension DLL and, when present,
creates the compute queue with `D3D12_COMMAND_QUEUE_THROTTLE_MAX_PERFORMANCE`
so the iGPU isn't power-throttled while simulating
(`include/ExtensionHelper.h:62-154`); absent hardware/driver support it
silently falls back to a plain queue, and the app can toggle it at runtime
(`Compute.cpp:148-157`).

The XLA equivalent of "ask the platform for a faster queue" is asking for
a more aggressive compilation: `compile()` lowers a jitted function and
compiles it with the GPU latency-hiding scheduler, which overlaps copies
and collectives with compute — the closest analog of the throttle hint.
Like the DLL probe, availability is discovered empirically: the first
compile attempt with options decides, and failure falls back to the plain
jit executable. Runtime-toggleable via `set_enabled`.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax

# The perf knobs requested when the extension is enabled. Unknown options
# make compilation fail -> detected by the probe, never fatal. The value
# is a bool: this JAX rejects the string "true" for a bool option.
PERF_COMPILER_OPTIONS = {
    "xla_gpu_enable_latency_hiding_scheduler": True,
}


class ExtensionHelper:
    """Probe-once wrapper around compile-with-options."""

    def __init__(self, device: Optional[jax.Device] = None, enabled: bool = True):
        self.device = device
        self.enabled = enabled
        self._available: Optional[bool] = None  # unknown until first probe

    # -- capability probe (the LoadLibrary analog) ---------------------------
    def available(self) -> bool:
        if self._available is None:
            try:
                fn = jax.jit(lambda x: x + 1.0)
                lowered = fn.lower(jax.ShapeDtypeStruct((8, 128), "float32"))
                lowered.compile(compiler_options=dict(PERF_COMPILER_OPTIONS))
                self._available = True
            except Exception:
                self._available = False
        return self._available

    def set_enabled(self, enabled: bool) -> None:
        """Runtime toggle (`Compute::SetUseIntelCommandQueueExtension`)."""
        self.enabled = enabled

    @property
    def active(self) -> bool:
        return self.enabled and self.available()

    # -- compile ----------------------------------------------------------------
    def compile(
        self,
        jitted: Callable,
        *example_args,
        **example_kwargs,
    ):
        """Compile a `jax.jit`-wrapped callable for the example arguments.

        With the extension active, compiles with PERF_COMPILER_OPTIONS;
        otherwise (or on failure) returns the plain jitted callable. The
        returned object is callable with arguments of the same shapes.
        """
        if self.active:
            try:
                lowered = jitted.lower(*example_args, **example_kwargs)
                return lowered.compile(
                    compiler_options=dict(PERF_COMPILER_OPTIONS)
                )
            except Exception:
                self._available = False  # driver said no: remember
        return jitted

    def describe(self) -> str:
        if self.active:
            return "perf extension: active (latency-hiding scheduler)"
        if self.enabled:
            return "perf extension: unavailable on this backend"
        return "perf extension: disabled"
