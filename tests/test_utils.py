"""PNG writer, checkpoint/resume, metrics registry, CLI parser."""

import os
import struct
import zlib

import numpy as np
import pytest

from multi_adapter_particles_tpu.models import init as pinit
from multi_adapter_particles_tpu.utils import checkpoint as ckpt
from multi_adapter_particles_tpu.utils.argparser import ArgParser
from multi_adapter_particles_tpu.utils.metrics import MetricsRegistry
from multi_adapter_particles_tpu.utils.png import write_png


class TestPng:
    def test_roundtrip_decodable(self, tmp_path):
        img = (np.random.default_rng(0).random((16, 32, 3)) * 255).astype(
            np.uint8
        )
        p = str(tmp_path / "f.png")
        write_png(p, img)
        raw = open(p, "rb").read()
        assert raw[:8] == b"\x89PNG\r\n\x1a\n"
        # decode IDAT manually and compare pixels
        off = 8
        idat = b""
        while off < len(raw):
            ln, tag = struct.unpack(">I4s", raw[off : off + 8])
            if tag == b"IDAT":
                idat += raw[off + 8 : off + 8 + ln]
            off += 12 + ln
        data = zlib.decompress(idat)
        h, w = img.shape[:2]
        out = np.zeros_like(img)
        stride = w * 3 + 1
        for y in range(h):
            row = data[y * stride : (y + 1) * stride]
            assert row[0] == 0  # filter none
            out[y] = np.frombuffer(row[1:], np.uint8).reshape(w, 3)
        np.testing.assert_array_equal(out, img)

    def test_float_input(self, tmp_path):
        img = np.zeros((8, 128, 3), np.float32)
        img[:, :, 0] = 1.0
        p = str(tmp_path / "g.png")
        write_png(p, img)
        assert os.path.getsize(p) > 0


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        state = pinit.initialize_particles_device(256, seed=5)
        p = str(tmp_path / "c.npz")
        ckpt.save_checkpoint(p, state, step=42, num_particles=256)
        loaded, step, n = ckpt.load_checkpoint(p)
        assert step == 42 and n == 256
        np.testing.assert_array_equal(
            np.asarray(state.position), np.asarray(loaded.position)
        )
        np.testing.assert_array_equal(
            np.asarray(state.velocity), np.asarray(loaded.velocity)
        )

    def test_resume_continues_trajectory(self, tmp_path):
        from multi_adapter_particles_tpu.config import SimConfig
        from multi_adapter_particles_tpu.models import integrator

        cfg = SimConfig(num_particles=256)
        step = integrator.make_step(cfg, donate=False)
        s = pinit.initialize_particles_device(256, seed=1)
        s = step(s)
        p = str(tmp_path / "c.npz")
        ckpt.save_checkpoint(p, s, step=1)
        ref = step(step(s))
        loaded, _, _ = ckpt.load_checkpoint(p)
        out = step(step(loaded))
        np.testing.assert_array_equal(
            np.asarray(out.position), np.asarray(ref.position)
        )


class TestMetrics:
    def test_stages_counters_gauges(self):
        m = MetricsRegistry()
        st = m.stage("simulate")
        st.add_sample(0.010)
        m.count("frames")
        m.count("transfer_bytes", 1024)
        m.gauge("mode_banner", "Test Mode")
        d = m.as_dict()
        assert d["stages_ms"]["simulate"] == pytest.approx(10.0)
        assert d["counters"]["transfer_bytes"] == 1024
        text = m.render_text()
        assert "Test Mode" in text and "simulate ms" in text

    def test_ema_window(self):
        m = MetricsRegistry(stage_window=20)
        st = m.stage("x")
        st.add_sample(1.0)
        for _ in range(100):
            st.add_sample(0.0)
        assert st.ema_seconds < 0.01  # decayed


class TestArgParser:
    def test_reference_flags(self):
        from multi_adapter_particles_tpu.app import build_parser
        from multi_adapter_particles_tpu.config import AppConfig

        app, extra = AppConfig(), {}
        p = build_parser(app, extra)
        p.parse(
            [
                "-numparticles", "1000", "-nogui", "-novsync", "-size", "5.5",
                "-intensity", "0.3", "-numsim", "100", "-numdraw", "200",
                "-numcopy", "300", "-fullscreen", "-noext",
            ]
        )
        assert app.num_particles == 1000
        assert not app.gui and not app.vsync and app.fullscreen
        assert not app.use_queue_extension
        assert app.particle_size == 5.5
        assert not app.linked
        assert (app.num_sim, app.num_copy, app.num_draw) == (100, 300, 200)

    def test_case_insensitive_and_help(self, capsys):
        from multi_adapter_particles_tpu.app import build_parser
        from multi_adapter_particles_tpu.config import AppConfig

        app, extra = AppConfig(), {}
        p = build_parser(app, extra)
        p.parse(["-NumParticles", "77"])
        assert app.num_particles == 77
        out = p.parse(["?"], exit_on_help=False)
        assert "numparticles" in capsys.readouterr().out

    def test_unmatched_returned(self):
        p = ArgParser("t")
        p.add_flag("x", "", lambda: None)
        assert p.parse(["-y"]) == ["-y"]


class TestPresets:
    def test_apply_known_preset(self):
        from multi_adapter_particles_tpu.config import AppConfig
        from multi_adapter_particles_tpu.presets import PRESETS, apply_preset

        app, extra = AppConfig(), {}
        apply_preset("1m-mesh8", app, extra)
        assert app.num_particles == 1_048_576
        assert extra["mesh_devices"] == 8
        assert extra["force"] == "all_pairs"

    def test_unknown_preset_exits(self):
        from multi_adapter_particles_tpu.config import AppConfig
        from multi_adapter_particles_tpu.presets import apply_preset

        with pytest.raises(SystemExit, match="unknown preset"):
            apply_preset("nope", AppConfig(), {})

    def test_all_presets_well_formed(self):
        from multi_adapter_particles_tpu.config import AppConfig
        from multi_adapter_particles_tpu.presets import PRESETS, apply_preset

        for name in PRESETS:
            app, extra = AppConfig(), {}
            apply_preset(name, app, extra)
            assert app.num_particles > 0


class TestCompileCache:
    def test_enable_and_off_round_trip(self, tmp_path):
        """enable(dir) points the JAX persistent cache there;
        enable('off') must actually UN-point it (two app.main() calls in
        one process, the second with -compilecache off, must not keep
        persisting to the first caller's directory)."""
        import jax

        from multi_adapter_particles_tpu.utils import compilecache

        before = jax.config.jax_compilation_cache_dir
        try:
            d = compilecache.enable(str(tmp_path / "xla"))
            assert d == str(tmp_path / "xla")
            assert compilecache.enabled_dir() == d
            assert jax.config.jax_compilation_cache_dir == d

            assert compilecache.enable("off") is None
            assert compilecache.enabled_dir() is None
            assert jax.config.jax_compilation_cache_dir is None
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_env_var_directory_is_used(self, tmp_path, monkeypatch):
        """With JAX_COMPILATION_CACHE_DIR set, "auto" uses exactly that
        directory and sets no other."""
        import jax

        from multi_adapter_particles_tpu.utils import compilecache

        want = str(tmp_path / "from-env")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        before = jax.config.jax_compilation_cache_dir
        try:
            assert compilecache.default_dir() == want
            assert compilecache.enable("auto") == want
            assert jax.config.jax_compilation_cache_dir == want
            assert os.path.isdir(want)
        finally:
            compilecache.enable("off")
            jax.config.update("jax_compilation_cache_dir", before)

    def test_default_is_a_fixed_path_in_the_checkout(self, monkeypatch):
        """Without the variable the cache lives at <checkout>/.jax_cache —
        the same path on every call and in every process (the path is
        part of the cache key), never a temporary or pid-derived one."""
        from multi_adapter_particles_tpu.utils import compilecache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        d = compilecache.default_dir()
        assert d == os.path.join(root, ".jax_cache")
        assert d == compilecache.default_dir()
        assert str(os.getpid()) not in d

    def test_cli_auto_uses_the_env_directory(self, tmp_path, monkeypatch):
        """`-compilecache` defaults to auto: an app launch with the
        variable set points JAX's cache at it."""
        import jax

        from multi_adapter_particles_tpu.app import main
        from multi_adapter_particles_tpu.utils import compilecache

        want = str(tmp_path / "cli-cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        before = jax.config.jax_compilation_cache_dir
        try:
            assert main(["-numparticles", "256", "-steps", "1", "-nogui",
                         "-novsync", "-nodraw"]) == 0
            assert compilecache.enabled_dir() == want
            assert jax.config.jax_compilation_cache_dir == want
        finally:
            compilecache.enable("off")
            jax.config.update("jax_compilation_cache_dir", before)
