"""Sim throughput across force models and particle counts (markdown table).

    python examples/throughput_table.py            # on the GPU
    python examples/throughput_table.py --quick    # smaller sweep
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models import init as pinit, integrator
from multi_adapter_particles_tpu.utils.timers import sync


def bench(force, n, steps=5, **cfg_kw):
    cfg = SimConfig(num_particles=n, force_model=force,
                    interaction_scale=1.0 / n, **cfg_kw)
    # all_pairs runs the implementation ops/dispatch picks for the device
    step = integrator.make_step(cfg)
    s = pinit.initialize_particles_device(n, seed=0)
    s = step(s)
    sync(s)
    t0 = time.perf_counter()
    for _ in range(steps):
        s = step(s)
    sync(s)
    return (time.perf_counter() - t0) / steps


def main():
    quick = "--quick" in sys.argv
    sizes = [262_144, 1_048_576] if quick else [262_144, 1_048_576, 4_194_304]
    rows = []
    for n in sizes:
        row = [f"{n:,}"]
        for force in ("central_well", "pm_grid", "all_pairs"):
            if force == "all_pairs" and n > 1_048_576 and not quick:
                row.append("—")  # O(N^2): 16x the 1M step; skip by default
                continue
            dt = bench(force, n, steps=3 if force == "all_pairs" else 5)
            row.append(f"{dt*1e3:,.1f} ms")
            print(f"  {force} @ {n:,}: {dt*1e3:,.1f} ms/step",
                  file=sys.stderr, flush=True)
        rows.append(row)
    print("| particles | central_well | pm_grid (G=64) | all_pairs (exact) |")
    print("|---|---|---|---|")
    for r in rows:
        print("| " + " | ".join(r) + " |")


if __name__ == "__main__":
    main()
