"""Renderer tests: camera math, color rules, and golden comparison of the
Tile-binned splatter against the exact sequential NumPy rasterizer
(survey SS4: 'golden-image/golden-histogram tests for the splat renderer')."""

import numpy as np
import pytest

from multi_adapter_particles_tpu import constants as C
from multi_adapter_particles_tpu.config import RenderConfig
from multi_adapter_particles_tpu.render import camera as cam
from multi_adapter_particles_tpu.render import reference as ref
from multi_adapter_particles_tpu.render.renderer import Renderer


class TestCamera:
    def test_default_view_looks_down_minus_z(self):
        c = cam.Camera()
        assert np.allclose(c.look_direction, (0, 0, -1), atol=1e-6)
        v = c.view_matrix()
        # eye at (0,0,1500): world origin maps to eye-space (0, 0, -1500)
        p = np.array([0, 0, 0, 1], dtype=np.float32) @ v
        assert np.allclose(p[:3], [0, 0, -1500], atol=1e-3)

    def test_projection_near_far(self):
        p = cam.perspective_fov_rh(C.CAMERA_FOV_Y, 1.0, 1.0, 5000.0)
        # view-space z=-near -> ndc z=0, z=-far -> ndc z=1, w = -z
        for z, expect in ((-1.0, 0.0), (-5000.0, 1.0)):
            clip = np.array([0, 0, z, 1.0]) @ p.astype(np.float64)
            assert clip[3] == pytest.approx(-z)
            assert clip[2] / clip[3] == pytest.approx(expect, abs=1e-6)

    def test_center_projection(self):
        """World origin must land in the image center."""
        cfg = RenderConfig(width=256, height=256)
        c = cam.Camera()
        cx, cy, hx, hy, w = ref.project_particles(
            np.zeros((1, 3), dtype=np.float32), c, cfg
        )
        assert cx[0] == pytest.approx(128.0, abs=1e-3)
        assert cy[0] == pytest.approx(128.0, abs=1e-3)
        assert w[0] == pytest.approx(1500.0)

    def test_fly_controls(self):
        c = cam.Camera()
        c.key_down("w")
        c.update(1.0)
        c.key_up("w")
        # looking down -z and moving forward decreases z by move_speed
        assert c.position[2] == pytest.approx(1500.0 - c.move_speed)
        c.key_down("left")
        c.update(1.0)
        assert c.yaw == pytest.approx(np.pi + c.turn_speed)
        c.reset()
        assert c.position == (0.0, 0.0, 1500.0) and c.yaw == pytest.approx(np.pi)

    def test_pitch_clamp(self):
        c = cam.Camera()
        c.key_down("up")
        c.update(10.0)
        assert c.pitch == pytest.approx(np.pi / 4)


class TestColors:
    def test_vs_color_rule(self):
        ids = np.arange(5)
        mags = np.array([0.0, 4.5, 9.0, 18.0, 0.0], dtype=np.float32)
        rgb = ref.particle_colors(mags, ids)
        b = (ids & 0xFFF) / float(0xFFF)
        np.testing.assert_allclose(rgb[:, 2], b, rtol=1e-6)
        np.testing.assert_allclose(rgb[:, 0], 1 - b, rtol=1e-6)
        # g = 0.1 + (mag/9) * 0.9, unclamped
        np.testing.assert_allclose(
            rgb[:, 1], 0.1 + (mags / 9) * 0.9, rtol=1e-5
        )
        assert rgb[3, 1] > 1.0  # unclamped lerp survives


def two_particle_scene():
    # two particles near the origin, distinct accel magnitudes
    pos = np.array(
        [
            [0.0, 0.0, 0.0, 0.0],
            [30.0, 20.0, -50.0, 4.5],
        ],
        dtype=np.float32,
    )
    return pos


class TestReferenceRasterizer:
    def test_single_sprite_geometry(self):
        cfg = RenderConfig(width=128, height=128)
        pos = np.array([[0.0, 0.0, 0.0, 0.0]], dtype=np.float32)
        frame = ref.render_reference(
            pos, cfg, particle_size=40.0, particle_intensity=1.0
        )
        # center pixel has the peak; brightness decays radially
        c = frame[64, 64]
        assert c.sum() > 0
        assert frame[64, 64].sum() >= frame[64, 68].sum() >= frame[64, 72].sum()
        # far corner untouched
        assert frame[0, 0].sum() == 0

    def test_blend_order_dependence(self):
        """Two coincident sprites with different colors: result must equal
        sequential over-blending in id order."""
        cfg = RenderConfig(width=128, height=128)
        pos = np.zeros((2, 4), dtype=np.float32)
        pos[1, 3] = 18.0  # different g via accel
        frame = ref.render_reference(
            pos, cfg, particle_size=40.0, particle_intensity=1.0
        )
        rgb = ref.particle_colors(pos[:, 3], np.arange(2))
        # manual blend at the exact center pixel
        cam_ = cam.Camera()
        cx, cy, hx, hy, _ = ref.project_particles(pos, cam_, cfg)
        u = (64.5 - (cx[0] - hx[0] * 40)) / (2 * hx[0] * 40)
        v = (64.5 - (cy[0] - hy[0] * 40)) / (2 * hy[0] * 40)
        a = np.clip(0.5 - np.hypot(u - 0.5, v - 0.5), 0, 0.5)
        expect = np.zeros(3)
        for i in range(2):
            # associative semantics: per-sprite source clamp, final clip
            expect = np.clip(rgb[i] * a, 0, 1) + expect * (1 - a)
        expect = np.clip(expect, 0, 1)
        np.testing.assert_allclose(frame[64, 64], expect, atol=1e-5)

    def test_num_draw(self):
        cfg = RenderConfig(width=128, height=128)
        pos = two_particle_scene()
        f1 = ref.render_reference(pos, cfg, num_draw=1, particle_size=10.0)
        f2 = ref.render_reference(pos[:1], cfg, particle_size=10.0)
        np.testing.assert_array_equal(f1, f2)


class TestTpuRenderer:
    @pytest.mark.parametrize("n", [1, 7, 100])
    def test_matches_reference(self, n):
        rng = np.random.default_rng(n)
        pos = np.zeros((n, 4), dtype=np.float32)
        pos[:, :3] = rng.uniform(-300, 300, size=(n, 3)).astype(np.float32)
        pos[:, 3] = rng.uniform(0, 12, size=n).astype(np.float32)
        cfg = RenderConfig(width=256, height=128)
        camera = cam.Camera()

        golden = ref.render_reference(
            pos, cfg, particle_size=6.0, particle_intensity=0.5
        )

        from multi_adapter_particles_tpu.models.state import ParticleState

        st = ParticleState.from_aos(pos, np.zeros((n, 3), np.float32))
        r = Renderer(cfg)
        frame = np.asarray(
            r.render(st.position, camera, 6.0, 0.5, num_draw=n)
        )
        assert r.last_overflow == 0
        # fp32 vs float64-projection oracle: allow small per-pixel slop
        assert np.abs(frame - golden).max() < 2e-3

    def test_deep_tile_exact(self):
        """Many coincident sprites (deeper than seg_q) composite exactly —
        the segmented engine has no depth cap (no silent truncation)."""
        n = 300
        pos = np.zeros((n, 4), dtype=np.float32)
        cfg = RenderConfig(width=128, height=128)
        from multi_adapter_particles_tpu.models.state import ParticleState

        st = ParticleState.from_aos(pos, np.zeros((n, 3), np.float32))
        r = Renderer(cfg, seg_q=16)  # forces ~19 segments on the hot tile
        # size 10 -> ~1 px half-extent at this window, so sprites actually
        # cover pixel centers (size 2.5 would be subpixel at 128 px)
        frame = r.render(st.position, cam.Camera(), 10.0, 0.15)
        assert r.last_overflow == 0
        golden = ref.render_reference(pos, cfg, particle_size=10.0)
        assert np.abs(np.asarray(frame) - golden).max() < 2e-3

    def test_truncation_reported(self):
        """A sprite spanning more tiles than the dup grid reports truncated."""
        pos = np.array([[0, 0, 0, 0]], dtype=np.float32)
        cfg = RenderConfig(width=256, height=256)
        from multi_adapter_particles_tpu.models.state import ParticleState

        st = ParticleState.from_aos(pos, np.zeros((1, 3), np.float32))
        r = Renderer(cfg)
        out = r.render_arrays(st.position, cam.Camera(), 200.0, 0.5)
        assert int(out.truncated) > 0

    def test_chunked_composite_matches_single_pass(self):
        """Chunked rendering (the bounded-memory path for huge N) folds
        id-ordered chunks through the associative (C, T) composite:
        same frame as single-pass up to fp reassociation, including the
        id-hash colors (global id offsets) and a num_draw prefix that
        cuts mid-chunk."""
        rng = np.random.default_rng(21)
        n = 512
        pos = np.zeros((n, 4), dtype=np.float32)
        pos[:, :3] = rng.uniform(-300, 300, size=(n, 3)).astype(np.float32)
        pos[:, 3] = rng.uniform(0, 12, size=n).astype(np.float32)
        from multi_adapter_particles_tpu.models.state import ParticleState

        st = ParticleState.from_aos(pos, np.zeros((n, 3), np.float32))
        cfg = RenderConfig(width=256, height=128)
        for num_draw in (None, 300):  # 300 cuts inside chunk 3 of 4
            single = Renderer(cfg)
            ref_out = single.render_arrays(
                st.position, cam.Camera(), 6.0, 0.5, num_draw=num_draw
            )
            chunked = Renderer(cfg)
            chunked.chunk_threshold = 256
            chunked.chunk_size = 128
            out = chunked.render_arrays(
                st.position, cam.Camera(), 6.0, 0.5, num_draw=num_draw
            )
            np.testing.assert_allclose(
                np.asarray(out.frame), np.asarray(ref_out.frame),
                atol=2e-5,
            )
            assert int(out.truncated) == int(ref_out.truncated)

    def test_chunked_handles_divisor_free_n(self):
        """Chunking must not require the chunk count to divide N: the last
        chunk is padded with parked (render-inert) particles instead of the
        old divisor search (which degenerated into up-to-N tiny dispatches
        for an N like 2*prime)."""
        rng = np.random.default_rng(33)
        n = 640  # chunk_size=256 -> k=3 does not divide 640
        pos = np.zeros((n, 4), dtype=np.float32)
        pos[:, :3] = rng.uniform(-300, 300, size=(n, 3)).astype(np.float32)
        from multi_adapter_particles_tpu.models.state import ParticleState

        st = ParticleState.from_aos(pos, np.zeros((n, 3), np.float32))
        cfg = RenderConfig(width=256, height=128)
        single = Renderer(cfg)
        ref_out = single.render_arrays(st.position, cam.Camera(), 6.0, 0.5)
        chunked = Renderer(cfg)
        chunked.chunk_threshold = 256
        chunked.chunk_size = 256
        out = chunked.render_arrays(st.position, cam.Camera(), 6.0, 0.5)
        np.testing.assert_allclose(
            np.asarray(out.frame), np.asarray(ref_out.frame), atol=2e-5
        )
        # the auto-raise budget divides by the per-dispatch sort size (the
        # chunk width), not the full particle count
        assert chunked._last_sort_n == 256
        assert single._last_sort_n == st.position.shape[1]

    def test_chunked_render_reuses_device_arg_cache(self):
        """A static camera must not re-upload per-frame scalars on the
        chunked (4M/16.8M) hot path: the second frame reuses the SAME
        cached device buffers (round-4 review catch — the chunked branch
        used to bypass `_device_args`)."""
        rng = np.random.default_rng(34)
        n = 512
        pos = np.zeros((n, 4), dtype=np.float32)
        pos[:, :3] = rng.uniform(-300, 300, size=(n, 3)).astype(np.float32)
        from multi_adapter_particles_tpu.models.state import ParticleState

        st = ParticleState.from_aos(pos, np.zeros((n, 3), np.float32))
        r = Renderer(RenderConfig(width=256, height=128))
        r.chunk_threshold = 256
        r.chunk_size = 256
        r.render_arrays(st.position, cam.Camera(), 6.0, 0.5)
        dev = r._arg_dev
        assert dev is not None
        r.render_arrays(st.position, cam.Camera(), 6.0, 0.5)
        assert r._arg_dev is dev  # identical frame args: no re-upload
        r.render_arrays(st.position, cam.Camera(), 7.0, 0.5)
        assert r._arg_dev is not dev  # changed size: cache invalidates

    def test_uint8_frame_mode(self):
        """RenderConfig.frame_uint8 (the swap-chain R8G8B8A8_UNORM analog)
        quantizes on device: dtype uint8 and within 1 LSB of the fp32
        frame everywhere."""
        rng = np.random.default_rng(5)
        n = 64
        pos = np.zeros((n, 4), dtype=np.float32)
        pos[:, :3] = rng.uniform(-300, 300, size=(n, 3)).astype(np.float32)
        from multi_adapter_particles_tpu.models.state import ParticleState

        st = ParticleState.from_aos(pos, np.zeros((n, 3), np.float32))
        cfg32 = RenderConfig(width=256, height=128)
        cfg8 = RenderConfig(width=256, height=128, frame_uint8=True)
        f32 = np.asarray(
            Renderer(cfg32).render(st.position, cam.Camera(), 6.0, 0.5)
        )
        f8 = np.asarray(
            Renderer(cfg8).render(st.position, cam.Camera(), 6.0, 0.5)
        )
        assert f8.dtype == np.uint8
        want = np.clip(f32, 0.0, 1.0) * 255.0
        assert np.abs(f8.astype(np.float64) - want).max() <= 0.501 + 1e-3

    def test_empty_frame(self):
        from multi_adapter_particles_tpu.models.state import zeros

        st = zeros(128)
        cfg = RenderConfig(width=128, height=128)
        r = Renderer(cfg)
        frame = np.asarray(r.render(st.position, cam.Camera(), 2.5, 0.15, num_draw=0))
        assert frame.sum() == 0


class TestAutoRaiseDup:
    def test_entry_budget_caps_growth(self):
        """A spanning sprite must not raise dup past the entry budget —
        at huge N each raise recompiles and multiplies the sort
        (regression for the 16.8M ~50x frame blow-up)."""
        from multi_adapter_particles_tpu.models.state import ParticleState

        pos = np.array([[0, 0, 0, 0]], dtype=np.float32)
        st = ParticleState.from_aos(pos, np.zeros((1, 3), np.float32))
        cfg = RenderConfig(width=256, height=256)
        r = Renderer(cfg)
        r.entry_budget = 4  # pretend N x dup is already at the budget
        out = r.render_arrays(st.position, cam.Camera(), 200.0, 0.5)
        assert int(out.truncated) > 0
        grew = r.raise_dup_for(out)
        assert not grew and (r.dup_y, r.dup_x) == (2, 2)
        # with budget, the same frame raises freely
        r2 = Renderer(cfg)
        out2 = r2.render_arrays(st.position, cam.Camera(), 200.0, 0.5)
        assert r2.raise_dup_for(out2)
        assert r2.dup_y * r2.dup_x > 4

    def test_size10_closeup_golden(self):
        """GUI-size-10 sprites with a close camera span many tiles: the
        auto-raised dup window makes the frame lossless (truncated == 0)
        and pixel-exact vs the sequential NumPy oracle."""
        rng = np.random.default_rng(7)
        n = 24
        pos = np.zeros((n, 4), dtype=np.float32)
        pos[:, :3] = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
        pos[:, 3] = rng.uniform(0, 9, size=n).astype(np.float32)
        cfg = RenderConfig(width=256, height=256)
        camera = cam.Camera(position=(0.0, 0.0, 60.0))

        from multi_adapter_particles_tpu.models.state import ParticleState

        st = ParticleState.from_aos(pos, np.zeros((n, 3), np.float32))
        r = Renderer(cfg)
        # sanity: the default 2x2 window really does truncate here
        pre = r.render_arrays(st.position, camera, 10.0, 0.15)
        assert int(pre.truncated) > 0
        frame = np.asarray(r.render(st.position, camera, 10.0, 0.15))
        assert r.last_truncated == 0
        assert (r.dup_y, r.dup_x) > (2, 2)
        golden = ref.render_reference(
            pos, cfg, camera=camera, particle_size=10.0,
            particle_intensity=0.15,
        )
        assert np.abs(frame - golden).max() < 2e-3

    def test_present_raises_for_future_frames(self):
        """The render engine's present() grows the window so the NEXT frame
        is lossless (swapchain-style deferred adaptation)."""
        import jax

        from multi_adapter_particles_tpu.config import AppConfig
        from multi_adapter_particles_tpu.models.state import ParticleState
        from multi_adapter_particles_tpu.runtime.render_engine import (
            RenderEngine,
        )

        pos = np.array([[0, 0, 0, 0]], dtype=np.float32)
        st = ParticleState.from_aos(pos, np.zeros((1, 3), np.float32))
        cfg = RenderConfig(width=256, height=256)
        eng = RenderEngine(cfg, jax.devices("cpu")[0])
        app = AppConfig(num_particles=1, particle_size=200.0)
        out0 = eng.draw(st.position, app)
        assert int(out0.truncated) > 0
        eng.present()
        assert (eng.renderer.dup_y, eng.renderer.dup_x) > (2, 2)
        out1 = eng.draw(st.position, app)
        assert int(out1.truncated) == 0


class TestSegQInvariance:
    def test_result_independent_of_seg_q(self):
        """seg_q is a pure performance knob: any value gives the same image
        (associativity of the segmented composite)."""
        import jax.numpy as jnp

        n = 100
        rng = np.random.default_rng(5)
        pos = np.zeros((4, n), np.float32)
        pos[:3] = rng.uniform(-50, 50, size=(3, n)).astype(np.float32)
        cfg = RenderConfig(width=128, height=64)
        camera = cam.Camera()
        frames = []
        for q in (4, 16, 128):
            r = Renderer(cfg, seg_q=q)
            out = r.render_arrays(jnp.asarray(pos), camera, 100.0, 0.3)
            frames.append(np.asarray(out.frame))
        np.testing.assert_allclose(frames[0], frames[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(frames[0], frames[2], rtol=1e-5, atol=1e-6)


class TestPallasComposite:
    """ops/composite.py through the Pallas interpreter on the CPU."""

    def test_row_hi_trip_count_bitwise(self):
        for blend in ("over", "additive"):
            self._check_trip_count(blend, 1100)

    @pytest.mark.parametrize("blend", ["over", "additive"])
    @pytest.mark.parametrize("v", [16, 7])
    def test_row_hi_trip_count_bitwise_small_v(self, blend, v):
        self._check_trip_count(blend, v)

    def _check_trip_count(self, blend, v):
        """Looping each block only to its rows' largest live bound is
        BITWISE equal to the full Q loop: slots at or past a row's hi
        carry alpha-scale 0 and zero-alpha blending is an exact identity
        (x*1 == x, +0 + 0 == +0). Random live windows, a dead row tail,
        and V values that are not multiples of the block width."""
        import jax.numpy as jnp

        from multi_adapter_particles_tpu.ops.composite import (
            composite_rows_triton,
        )

        rng = np.random.default_rng(v)
        q = 32
        sp = rng.uniform(-3, 3, size=(8, q, v)).astype(np.float32)
        hi = rng.integers(0, q + 1, size=v).astype(np.int32)
        hi[(9 * v) // 11:] = 0  # dead tail -> trailing blocks loop 0 times
        kk = np.arange(q)[:, None]
        sp[7] = np.where(kk < hi[None, :], np.abs(sp[7]), 0.0)
        bases = rng.uniform(0, 64, size=(2, v)).astype(np.float32)
        sp_j, bases_j, hi_j = map(jnp.asarray, (sp, bases, hi))
        full = composite_rows_triton(
            sp_j, bases_j, jnp.full((v,), q, jnp.int32), 8, 16, blend=blend,
            interpret=True,
        )
        trip = composite_rows_triton(
            sp_j, bases_j, hi_j, 8, 16, blend=blend, interpret=True
        )
        a, b = np.asarray(full), np.asarray(trip)
        assert a.shape == b.shape == (4, v, 128)
        np.testing.assert_array_equal(a, b)

    def test_kernel_matches_xla_scan(self):
        self._check_scan(64, 8, "over")

    @pytest.mark.parametrize("n,seg_q,blend", [
        (100, 12, "over"),
        (64, 8, "additive"),
    ])
    def test_kernel_matches_xla_scan_variants(self, n, seg_q, blend):
        self._check_scan(n, seg_q, blend)

    def _check_scan(self, n, seg_q, blend):
        """The Triton composite (interpreted) == the XLA scan path on a
        tiny scene, including a Q that is not a power of two and a
        padded particle tail parked at 1e9."""
        import jax.numpy as jnp

        from multi_adapter_particles_tpu.render.renderer import _render

        rng = np.random.default_rng(3 + n)
        pos = np.zeros((4, 128), np.float32)
        pos[:3, :n] = rng.uniform(-50, 50, size=(3, n)).astype(np.float32)
        pos[:3, n:] = 1e9
        cfg = RenderConfig(width=64, height=16)
        camera = cam.Camera()
        proj = camera.projection_matrix(cfg.aspect)
        wvp = jnp.asarray(camera.world_view_projection(cfg.aspect))
        args = (
            jnp.asarray(pos), wvp,
            jnp.float32(abs(proj[0, 0])), jnp.float32(abs(proj[1, 1])),
            jnp.float32(100.0), jnp.float32(0.4), jnp.int32(n),
        )
        kw = dict(width=cfg.width, height=cfg.height, seg_q=seg_q,
                  dup_y=2, dup_x=2, near=cfg.near, blend=blend)
        a = _render(*args, composite="xla", **kw)
        b = _render(*args, composite="triton-interpret", **kw)
        np.testing.assert_allclose(
            np.asarray(a.frame), np.asarray(b.frame), rtol=1e-5, atol=1e-6
        )
        assert np.asarray(a.frame).max() > 0


class TestCameraVariationGolden:
    @pytest.mark.parametrize("yaw,pitch,dist", [
        (np.pi + 0.4, 0.2, 1500.0),
        (np.pi - 0.3, -0.35, 900.0),
    ])
    def test_matches_reference_under_fly_camera(self, yaw, pitch, dist):
        """Golden comparison holds for non-default camera poses (the fly
        controls the reference wires but never uses, SimpleCamera.cpp)."""
        rng = np.random.default_rng(int(yaw * 100))
        n = 50
        pos = np.zeros((n, 4), dtype=np.float32)
        pos[:, :3] = rng.uniform(-250, 250, size=(n, 3)).astype(np.float32)
        pos[:, 3] = rng.uniform(0, 9, size=n).astype(np.float32)
        cfg = RenderConfig(width=256, height=128)
        camera = cam.Camera(position=(100.0, -50.0, dist))
        camera.yaw = yaw
        camera.pitch = pitch

        golden = ref.render_reference(
            pos, cfg, camera=camera, particle_size=8.0,
            particle_intensity=0.6,
        )
        from multi_adapter_particles_tpu.models.state import ParticleState

        st = ParticleState.from_aos(pos, np.zeros((n, 3), np.float32))
        r = Renderer(cfg)
        frame = np.asarray(
            r.render(st.position, camera, 8.0, 0.6, num_draw=n)
        )
        assert np.abs(frame - golden).max() < 2e-3
        assert frame.max() > 0


class TestStartsTwoLevel:
    """Pin `_starts_two_level` == searchsorted(side='left') on adversarial
    sorted-key layouts (the renderer relies on it for tile starts)."""

    @staticmethod
    def _check(keys, num_queries, chunk):
        import jax.numpy as jnp

        from multi_adapter_particles_tpu.render.renderer import (
            _starts_two_level,
        )

        k = jnp.asarray(np.sort(np.asarray(keys, np.float32)))
        got = np.asarray(_starts_two_level(k, num_queries, chunk=chunk))
        want = np.searchsorted(np.asarray(k), np.arange(num_queries), "left")
        np.testing.assert_array_equal(got, want.astype(np.int32))

    @pytest.mark.parametrize("chunk", [8, 32, 128])
    def test_random_duplicate_heavy(self, chunk):
        rng = np.random.default_rng(7)
        # few distinct values over many entries: long duplicate runs that
        # straddle chunk boundaries, plus values with zero entries
        keys = rng.integers(0, 40, size=1024)
        self._check(keys, 41, chunk)

    @pytest.mark.parametrize("chunk", [8, 128])
    def test_run_exactly_at_chunk_boundary(self, chunk):
        # value v occupies exactly entries [chunk, 2*chunk): the boundary
        # chunk's minimum equals the query
        keys = np.concatenate([
            np.zeros(chunk), np.full(chunk, 5.0), np.full(6 * chunk, 9.0),
        ])
        self._check(keys, 12, chunk)

    def test_all_equal_and_extremes(self):
        # every entry identical; queries below, at, and beyond it
        self._check(np.full(256, 3.0), 8, 32)
        # queries past the max key must all return E
        self._check(np.arange(256) % 4, 10, 32)

    def test_fallback_when_not_divisible(self):
        # E % chunk != 0 routes to plain searchsorted — still exact
        self._check(np.arange(100), 101, 32)

    def test_sentinel_tail(self):
        # renderer keys park dead entries at a large sentinel past every
        # real tile; starts for real tiles must ignore the tail
        keys = np.concatenate([
            np.repeat(np.arange(16), 8), np.full(128, 4096.0),
        ])
        self._check(keys, 17, 32)
