"""Startup-probe sidecar cache (utils/probecache.py) + auto_grid reuse.

Covers: JSON round-trip with exact key reconstruction, corrupt-file
degradation, warm-cache auto_grid never touching positions, and the
cold->warm equivalence of the pick.
"""

import json

import numpy as np
import pytest

from multi_adapter_particles_tpu.ops.treeforce import (
    auto_grid,
    counts_cache_key,
    host_tree_counts,
)
from multi_adapter_particles_tpu.utils.probecache import (
    ProbeCache,
    open_cache,
)


def _scene(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    pos = np.full((4, n), 1e9, np.float32)
    pos[:3] = np.concatenate([
        rng.normal(0, 120, (3, n // 2)),
        rng.normal(400, 80, (3, n - n // 2)),
    ], axis=1).astype(np.float32)
    return pos


class TestSidecar:
    def test_round_trip(self, tmp_path):
        p = str(tmp_path / "probes.json")
        c = open_cache(p, 4096, 0, 2048.0, 6.75)
        ck = counts_cache_key(9, 216.0)
        c.counts[ck] = (123, 512)
        c.counts[counts_cache_key(15, 108.5)] = (44, 4096)
        c.overflow[(128, 8)] = 7
        c.save()

        c2 = open_cache(p, 4096, 0, 2048.0, 6.75)
        assert c2.counts[ck] == (123, 512)
        assert c2.counts[counts_cache_key(15, 108.5)] == (44, 4096)
        assert c2.overflow[(128, 8)] == 7

    def test_scene_keys_isolate(self, tmp_path):
        p = str(tmp_path / "probes.json")
        c = open_cache(p, 4096, 0, 2048.0, 6.75)
        c.counts[counts_cache_key(9, 216.0)] = (1, 512)
        c.save()
        # different seed -> different scene -> empty view, same file
        c2 = open_cache(p, 4096, 1, 2048.0, 6.75)
        assert not c2.counts
        c2.counts[counts_cache_key(9, 216.0)] = (2, 512)
        c2.save()
        # both survive
        assert open_cache(p, 4096, 0, 2048.0, 6.75).counts[
            counts_cache_key(9, 216.0)
        ] == (1, 512)
        assert open_cache(p, 4096, 1, 2048.0, 6.75).counts[
            counts_cache_key(9, 216.0)
        ] == (2, 512)

    def test_corrupt_file_degrades_to_empty(self, tmp_path):
        p = tmp_path / "probes.json"
        p.write_text("{ not json !!")
        c = open_cache(str(p), 4096, 0, 2048.0, 6.75)
        assert c.counts == {} and c.overflow == {}
        c.counts[counts_cache_key(9, 216.0)] = (5, 512)
        c.save()  # and saving over the corpse works
        assert json.loads(p.read_text())

    def test_off_spec_disables_persistence(self, tmp_path, monkeypatch):
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
        c = open_cache("off", 4096, 0, 2048.0, 6.75)
        assert c.path is None
        c.counts[counts_cache_key(9, 216.0)] = (5, 512)
        c.save()  # no-op
        assert not list(tmp_path.rglob("*.json"))

    def test_auto_spec_uses_xdg_cache(self, tmp_path, monkeypatch):
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
        c = open_cache(None, 4096, 0, 2048.0, 6.75)
        c.save()
        assert (
            tmp_path / "multi_adapter_particles_tpu" / "probes.json"
        ).exists()


class TestAutoGridCache:
    def test_warm_cache_skips_positions_entirely(self):
        """Cold run fills the cache; warm run gets the same pick from a
        position callable that MUST NOT be called (the whole point: no
        device init, no Morton sorts on a repeat launch)."""
        pos = _scene()
        box, cutoff = 2048.0, 6.75
        cache: dict = {}
        g_cold = auto_grid(pos, box, cutoff, counts_cache=cache,
                           num_particles=pos.shape[1])
        assert cache  # probes were recorded

        def boom():
            raise AssertionError("warm auto_grid touched positions")

        g_warm = auto_grid(boom, box, cutoff, counts_cache=cache,
                           num_particles=pos.shape[1])
        assert g_warm == g_cold

    def test_cache_entries_match_direct_probes(self):
        pos = _scene(seed=7)
        box, cutoff = 2048.0, 6.75
        cache: dict = {}
        auto_grid(pos, box, cutoff, counts_cache=cache,
                  num_particles=pos.shape[1])
        for (gn, rc_s), triple in cache.items():
            direct = host_tree_counts(pos, box, float(rc_s), gn)
            assert tuple(triple) == tuple(direct)

    def test_lazy_position_materializes_once_on_miss(self):
        pos = _scene(seed=11)
        calls = []

        def lazy():
            calls.append(1)
            return pos

        cache: dict = {}
        g = auto_grid(lazy, 2048.0, 6.75, counts_cache=cache,
                      num_particles=pos.shape[1])
        assert len(calls) == 1  # one materialization for all candidates
        assert g == auto_grid(pos, 2048.0, 6.75)
