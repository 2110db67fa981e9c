import os

import jax.numpy as jnp
import numpy as np

from gdslam_tpu.backend import gba, map_arena as ma
from gdslam_tpu.config import CameraConfig, SlamConfig
from gdslam_tpu.utils import checkpoint, telemetry, viewer


class TestCheckpoint:
    def test_roundtrip(self, tmp_path, rng):
        arena = ma.new_arena(kmax=8, pmax=64, n_features=16)
        arena = arena._replace(
            pt_pos=arena.pt_pos.at[:5].set(jnp.asarray(rng.normal(size=(5, 3)),
                                                       jnp.float32)),
            pt_valid=arena.pt_valid.at[:5].set(True),
            n_pt=jnp.asarray(5, jnp.int32),
            kf_valid=arena.kf_valid.at[0].set(True),
            n_kf=jnp.asarray(1, jnp.int32))
        p = str(tmp_path / "map.npz")
        checkpoint.save_map(arena, p)
        back = checkpoint.load_map(p)
        for k in ma.MapArena._fields:
            np.testing.assert_array_equal(np.asarray(getattr(arena, k)),
                                          np.asarray(getattr(back, k)))


class TestGBA:
    def test_improves_perturbed_map(self, rng):
        import sys
        sys.path.insert(0, os.path.dirname(__file__))
        from test_ba import CAM, CFG, make_arena, pose_errors
        arena, poses_gt, pts_gt = make_arena(rng, pose_noise=0.02)
        e0 = pose_errors(arena, poses_gt).max()
        out = gba.global_bundle_adjustment(arena, CFG, sweeps=6)
        e1 = pose_errors(out, poses_gt).max()
        assert e1 < 0.5 * e0
        assert bool(jnp.all(jnp.isfinite(out.pt_pos)))

    def test_keyframe_culling(self, rng):
        import sys
        sys.path.insert(0, os.path.dirname(__file__))
        from test_ba import make_arena
        arena, _, _ = make_arena(rng)
        # make every point heavily observed -> middle keyframes redundant
        arena = arena._replace(pt_n_obs=jnp.full(arena.pmax, 6, jnp.int32))
        out = gba.keyframe_culling(arena)
        kept = np.asarray(out.kf_valid)
        assert kept[0]                       # anchor survives
        assert not kept[1:4].all()           # some middles culled
        assert kept[int(out.n_kf) - 1]       # most recent protected


class TestTelemetry:
    def test_jsonl_log(self, tmp_path):
        p = str(tmp_path / "m.jsonl")
        log = telemetry.MetricsLogger(p)
        log.log(frame=0, state="OK", inliers=123)
        log.log(frame=1, state="OK", inliers=120)
        log.close()
        import json
        lines = [json.loads(l) for l in open(p)]
        assert len(lines) == 2 and lines[1]["inliers"] == 120

    def test_stage_timer(self):
        t = telemetry.StageTimer()
        with t("x"):
            pass
        assert "x" in t.summary()


class TestViewer:
    def test_draw_frame_and_map(self, rng):
        from gdslam_tpu.frontend.frame import Frame
        H, W = 48, 64
        frame = Frame(
            uv=jnp.asarray(rng.uniform(5, 40, (10, 2)), jnp.float32),
            uv_raw=jnp.zeros((10, 2)), ur=-jnp.ones(10), depth=jnp.zeros(10),
            level=jnp.zeros(10, jnp.int32), angle=jnp.zeros(10),
            response=jnp.ones(10), desc=jnp.zeros((10, 32), jnp.uint8),
            valid=jnp.ones(10, bool))
        img = viewer.draw_frame(np.full((H, W), 100.0), frame)
        assert img.shape == (H, W, 3)
        assert (img[..., 1] == 255).any()    # keypoints drawn

        arena = ma.new_arena(kmax=4, pmax=32, n_features=8)
        arena = arena._replace(
            pt_pos=arena.pt_pos.at[:9].set(
                jnp.asarray(rng.uniform(-1, 1, (9, 3)), jnp.float32)),
            pt_valid=arena.pt_valid.at[:9].set(True),
            kf_valid=arena.kf_valid.at[:2].set(True))
        m = viewer.draw_map(arena, size=64)
        assert m.shape == (64, 64, 3)
        assert m.sum() > 0


class TestNativeLoader:
    def test_native_matches_pil(self, tmp_path, rng):
        from PIL import Image

        from gdslam_tpu.io import native_loader
        from gdslam_tpu.io.tum import TumSequence
        d = str(tmp_path)
        os.makedirs(d + "/rgb"), os.makedirs(d + "/depth")
        lines = []
        for i in range(3):
            rgb = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
            dep = rng.integers(0, 20000, (24, 32)).astype(np.uint16)
            Image.fromarray(rgb).save(f"{d}/rgb/{i}.png")
            Image.fromarray(dep).save(f"{d}/depth/{i}.png")
            lines.append(f"{i}.0 rgb/{i}.png {i}.0 depth/{i}.png")
        open(d + "/a.txt", "w").write("\n".join(lines))
        seq_n = native_loader.NativeTumSequence(d, d + "/a.txt", 5000.0, 32, 24)
        seq_p = TumSequence(d, d + "/a.txt")
        for i, (rgb_n, dep_n, ts) in enumerate(seq_n):
            rgb_p, dep_p, ts_p = seq_p[i]
            np.testing.assert_array_equal(rgb_n, rgb_p)
            np.testing.assert_allclose(dep_n, dep_p, atol=1e-6)
            assert ts == ts_p
