"""Force-model accuracy ladder vs the exact all-pairs sum.

Two scenes, because the near-field capacity story differs:

- "halo": a moderate-density uniform cloud. The fixed-capacity near
  sweep covers every particle (overflow 0) and p3m delivers its <1% RMS
  promise at mesh-method cost.
- "clusters": the demo's two dense blobs. Core cells exceed any
  practical static capacity and the overflow count reports how many
  particles fell back to the smooth LONG-RANGE mesh force — which is
  smoother than pure PM's kernel, so on overflow-dominated scenes the
  SLOT sweep is WORSE than pm_grid there (while on the covered halo
  scene p3m is far closer to exact than pm). The
  round-3 TREE near field (near_mode="tree", ops/treeforce.py) restores
  the <1% promise on such scenes — the CLI's `-p3mnear auto` probe picks
  it automatically.

    python examples/p3m_accuracy.py            # on the GPU
    JAX_PLATFORMS=cpu python examples/p3m_accuracy.py --quick
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

_want = os.environ.get("JAX_PLATFORMS")
if _want and jax.config.jax_platforms != _want:
    try:
        jax.config.update("jax_platforms", _want)
    except RuntimeError:
        pass

import jax.numpy as jnp
import numpy as np

from multi_adapter_particles_tpu.models import integrator
from multi_adapter_particles_tpu.ops import p3m, pm

MASS = 70000.0
EPS2 = 25.0
BOX = 4096.0


def scene(name, n, rng):
    if name == "halo":
        pos3 = rng.uniform(-900, 900, (n, 3))
    else:  # the demo's two clusters + a thin halo
        a = rng.normal((-300, 0, 0), 120, (n // 2, 3))
        b = rng.normal((300, 0, 0), 120, (n // 2 - n // 8, 3))
        halo = rng.uniform(-900, 900, (n // 8, 3))
        pos3 = np.concatenate([a, b, halo])
    p = np.zeros((4, n), np.float32)
    p[:3] = pos3.astype(np.float32).T
    return jnp.asarray(p)


def main() -> int:
    quick = "--quick" in sys.argv
    n = 512 if quick else 8192
    cap = 128 if quick else 256
    rng = np.random.default_rng(3)
    scale = 1.0 / n
    g_const = MASS * scale

    for name in ("halo", "clusters"):
        pos = scene(name, n, rng)
        a_exact = np.asarray(
            integrator.all_pairs_accel(
                pos, mass=MASS, softening_squared=EPS2,
                interaction_scale=scale,
            )
        )
        norm = np.abs(a_exact).max()
        print(f"scene={name} n={n} backend={jax.default_backend()} "
              "(error vs exact O(N²) sum)")

        def report(label, fn, pos=pos, a_exact=a_exact, norm=norm):
            out, overflow = fn(pos)
            out = np.asarray(out)
            t0 = time.perf_counter()
            for _ in range(3):
                out = np.asarray(fn(pos)[0])
            dt = (time.perf_counter() - t0) / 3
            rms = float(np.sqrt(np.mean((out - a_exact) ** 2)) / norm)
            ov = "" if overflow is None else f"  overflow {int(overflow)}"
            print(f"  {label:>8}: rms {rms*100:6.2f}%  {dt*1e3:8.2f} ms{ov}")

        report("pm_grid", lambda q: (pm.pm_accel(
            q, grid=64, box=BOX, g_const=g_const,
            softening_squared=EPS2), None))
        report("p3m", lambda q: p3m.p3m_accel_with_overflow(
            q, grid=64, box=BOX, g_const=g_const, softening_squared=EPS2,
            capacity=cap))
        # the round-3 tree near field: exact on BOTH scenes — on the
        # overflowing clusters it replaces the slot sweep's degraded
        # result with the <1% promise (overflow column = dropped pairs)
        report("p3m-tree", lambda q: p3m.p3m_accel_with_overflow(
            q, grid=64, box=BOX, g_const=g_const, softening_squared=EPS2,
            near_mode="tree"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
