"""Named benchmark presets — the BASELINE.json staged configs.

Each preset is a dict of (AppConfig fields, extra CLI keys) applied by
`-preset NAME`; later flags override. See BASELINE.json "configs".
"""

from __future__ import annotations

PRESETS = {
    # 10k particles, softened all-pairs gravity + Euler, headless, 1 device
    "10k-allpairs": {
        "app": {"num_particles": 10_240, "gui": False, "vsync": False},
        "extra": {"force": "all_pairs", "draw": False, "steps": 200},
    },
    # 100k on one device: the blocked Pallas (Triton) force kernel
    "100k-pallas": {
        "app": {"num_particles": 102_400, "gui": False, "vsync": False},
        "extra": {"force": "all_pairs", "draw": False, "steps": 100},
    },
    # 256k with 720p splat render every step, per-phase timing
    "256k-720p": {
        "app": {"num_particles": 262_144, "vsync": False},
        "extra": {
            "width": 1280, "height": 720, "steps": 120, "profile_every": 10,
        },
    },
    # 1M sharded across 8 devices: positions all-gathered between devices
    "1m-mesh8": {
        "app": {"num_particles": 1_048_576, "gui": False, "vsync": False},
        "extra": {"force": "all_pairs", "mesh_devices": 8, "steps": 20},
    },
    # 4M with fused async sim/render overlap (one device)
    "4m-fused": {
        "app": {"num_particles": 4_194_304, "vsync": False},
        "extra": {"fused": True, "steps": 60},
    },
    # 4M SELF-gravity via FFT particle-mesh (exceeds the reference: PM is
    # O(N + G^3 log G) where the exact sum is O(N^2))
    "4m-pm": {
        "app": {"num_particles": 4_194_304, "gui": False, "vsync": False},
        "extra": {"force": "pm_grid", "draw": False, "steps": 30},
    },
    # 16.8M self-gravity + exact splat on ONE device: PM G=128 + the
    # chunked-composite render (bounded memory at any N)
    "16m-pm": {
        "app": {"num_particles": 16_777_216, "gui": False, "vsync": False},
        "extra": {
            "force": "pm_grid", "steps": 10, "pm_grid_size": 128,
            "interaction_scale": 1.0 / 16_777_216,
        },
    },
    # The reference's DEFAULT scene (N = 4,194,304, defines.h:44) with
    # EXACT-at-all-separations self-gravity: tree-P3M near field (the
    # XLA block-pair sweep over 2048-particle Morton blocks) + scene-probed
    # auto grid. tree-P3M holds <0.1% RMS of the exact O(N^2) sum.
    "4m-tree": {
        "app": {"num_particles": 4_194_304, "gui": False, "vsync": False},
        "extra": {
            "force": "p3m", "draw": False, "steps": 10,
            "p3m_near_mode": "tree",
            "interaction_scale": 1.0 / 4_194_304,
        },
    },
    # 64k P3M self-gravity: exact at all separations on ANY scene. The
    # demo's two-cluster init concentrates most particles into a few near
    # cells (max ~7.5k/cell at this config — far beyond any static slot
    # capacity), so the startup probe auto-selects the Morton-block
    # dual-tree near field (ops/treeforce.py) whose work scales with the
    # actual near-pair count; uniform-to-moderate scenes keep the faster
    # static-slot 27-cell sweep (<0.1% RMS, overflow 0 — see
    # examples/p3m_accuracy.py's halo scene).
    "64k-p3m": {
        "app": {"num_particles": 65_536, "gui": False, "vsync": False},
        "extra": {
            "force": "p3m", "draw": False, "steps": 100,
            "pm_box": 4096.0, "interaction_scale": 1.0 / 65_536,
        },
    },
}


def apply_preset(name: str, app_cfg, extra: dict) -> None:
    try:
        p = PRESETS[name]
    except KeyError:
        raise SystemExit(
            f"unknown preset {name!r}; available: {', '.join(sorted(PRESETS))}"
        )
    for k, v in p["app"].items():
        setattr(app_cfg, k, v)
    extra.update(p["extra"])
