import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gdslam_tpu.config import CameraConfig, OrbConfig, SlamConfig
from gdslam_tpu.core import lie
from gdslam_tpu.io import synthetic
from gdslam_tpu.masking import geometry as geo
from gdslam_tpu.masking import geomask
from gdslam_tpu.ops import edges as edge_ops
from gdslam_tpu.ops import flow as flow_ops
from gdslam_tpu.ops import image as image_ops

# Small rig so CPU tests stay fast.
SCAM = CameraConfig(fx=134.0, fy=135.0, cx=80.0, cy=60.0, width=160, height=120)
SCFG = SlamConfig(camera=SCAM, orb=OrbConfig(n_features=256, n_levels=4))


@pytest.fixture(scope="module")
def seq():
    return [synthetic.render_frame(i, SCAM, with_dynamic=True) for i in range(10)]


class TestFlow:
    def test_known_shift(self, rng):
        img1 = image_ops.gaussian_blur(
            jnp.asarray(rng.uniform(0, 255, (96, 96)), jnp.float32), 7, 2.0)
        img2 = jnp.roll(img1, (3, 6), axis=(0, 1))
        fl = flow_ops.farneback_flow(img1, img2)
        inner = fl[25:-25, 25:-25]
        assert abs(float(jnp.median(inner[..., 0])) - 6) < 0.3
        assert abs(float(jnp.median(inner[..., 1])) - 3) < 0.3

    def test_zero_flow_on_identical(self, rng):
        img = image_ops.gaussian_blur(
            jnp.asarray(rng.uniform(0, 255, (64, 64)), jnp.float32), 7, 2.0)
        fl = flow_ops.farneback_flow(img, img)
        assert float(jnp.abs(fl).max()) < 0.1

    def test_poly_expansion_quadratic(self):
        v, u = jnp.mgrid[0:32, 0:32]
        img = (2.0 + 3.0 * u + 4.0 * v + 0.5 * u * u).astype(jnp.float32)
        A, b = flow_ops.poly_expansion(img)
        assert abs(float(b[16, 16, 0]) - (3 + 16.0)) < 1e-2
        assert abs(float(b[16, 16, 1]) - 4.0) < 1e-2
        assert abs(float(A[16, 16, 0, 0]) - 0.5) < 1e-2


class TestEdges:
    def test_flat_plane_no_edges(self):
        depth = jnp.full((60, 80), 2.0)
        e = edge_ops.depth_edges(depth, CameraConfig(width=80, height=60))
        assert int(e[5:-5, 5:-5].sum()) == 0

    def test_depth_step_is_edge(self):
        depth = jnp.full((60, 80), 2.0).at[:, 40:].set(1.0)
        e = edge_ops.depth_edges(depth, CameraConfig(width=80, height=60))
        cols = np.nonzero(np.asarray(e[30]))[0]
        assert len(cols) > 0
        assert (np.abs(cols - 40) <= 2).all()

    def test_synthetic_sphere_boundary(self, seq):
        e = np.asarray(edge_ops.depth_edges(seq[0].depth, SCAM))
        dyn = np.asarray(seq[0].dyn_mask)
        # boundary of the sphere should contain edges
        from gdslam_tpu.frontend.frame import dilate_mask
        boundary = np.asarray(dilate_mask(jnp.asarray(dyn), 3)) & ~dyn
        assert e[boundary].mean() > 0.1


class TestGeoMask:
    @pytest.mark.e2e   # minute-scale compile; full run covers it
    def test_warmup_passthrough(self, seq):
        gm = geomask.GeoMaskMaker(SCFG)
        ones = jnp.ones((120, 160))
        gm.add_new_image(seq[0].gray, seq[0].depth, ones)
        m = gm.get_mask(ones)
        np.testing.assert_array_equal(np.asarray(m), np.ones((120, 160)))

    @pytest.mark.e2e   # minute-scale compile; full run covers it
    def test_static_scene_keeps_mask(self):
        frames = [synthetic.render_frame(i, SCAM, with_dynamic=False)
                  for i in range(7)]
        gm = geomask.GeoMaskMaker(SCFG)
        ones = jnp.ones((120, 160))
        for fr in frames:
            gm.add_new_image(fr.gray, fr.depth, ones)
        m = np.asarray(gm.get_mask(ones))
        # no dynamic object -> mask should stay mostly static
        assert (m < 0.5).mean() < 0.10

    def test_dynamic_sphere_detected(self, seq):
        gm = geomask.GeoMaskMaker(SCFG)
        ones = jnp.ones((120, 160))
        for fr in seq:
            gm.add_new_image(fr.gray, fr.depth, ones)
        m = np.asarray(gm.get_mask(ones))
        dyn = np.asarray(seq[-1].dyn_mask)
        pred = m < 0.5
        recall = (dyn & pred).sum() / max(dyn.sum(), 1)
        # At this tiny resolution the flow fidelity is heavily degraded; the
        # full-resolution gate runs on the GPU in chip_smoke.py. This bound
        # just catches total breakage.
        assert recall > 0.08
        # and not wildly over-masking
        assert pred.mean() < 0.35

    def test_mahalanobis_invalid_depth_passthrough(self):
        H, W = 120, 160
        mask, dist = geomask.mahalanobis_mask(
            jnp.zeros((H, W)), jnp.zeros((H, W)), jnp.zeros((H, W, 2)),
            jnp.eye(4), jnp.ones((H, W)), SCFG)
        np.testing.assert_array_equal(np.asarray(mask), np.ones((H, W)))


class TestGeometry:
    def _db_from(self, frames, idxs):
        g = geo.Geometry(SCFG)
        T0 = np.asarray(frames[0].T_wc)
        for i in idxs:
            fr = frames[i]
            T_cw = jnp.asarray(np.linalg.inv(np.linalg.inv(T0) @ np.asarray(fr.T_wc)))
            # DB stores masked frames (known-dynamic areas excluded), as the
            # reference does — it inserts frames post-masking.
            db_mask = jnp.asarray((~np.asarray(fr.dyn_mask)).astype(np.float32))
            g.update_db(fr.gray, fr.depth, db_mask, fr.rgb, T_cw, True)
        return g, T0

    def test_empty_db_passthrough(self, seq):
        g = geo.Geometry(SCFG)
        ones = jnp.ones((120, 160))
        m = g.geometric_model_correction(seq[0].depth, jnp.eye(4), ones)
        np.testing.assert_array_equal(np.asarray(m), np.ones((120, 160)))

    def test_dynamic_detected(self, seq):
        g, T0 = self._db_from(seq, [0, 2, 4, 6])
        fr = seq[9]
        T_cw = jnp.asarray(np.linalg.inv(np.linalg.inv(T0) @ np.asarray(fr.T_wc)))
        m = np.asarray(g.geometric_model_correction(
            fr.depth, T_cw, jnp.ones((120, 160))))
        dyn = np.asarray(fr.dyn_mask)
        pred = m < 0.5
        recall = (dyn & pred).sum() / max(dyn.sum(), 1)
        prec = (dyn & pred).sum() / max(pred.sum(), 1)
        assert recall > 0.2
        assert prec > 0.25

    def test_inpaint_fills_holes(self, seq):
        g, T0 = self._db_from(seq, [0, 2, 4, 6])
        fr = seq[9]
        T_cw = jnp.asarray(np.linalg.inv(np.linalg.inv(T0) @ np.asarray(fr.T_wc)))
        static_mask = jnp.asarray((~np.asarray(fr.dyn_mask)).astype(np.float32))
        rgb_out, depth_out = g.inpaint_frames(fr.rgb, fr.depth, static_mask, T_cw)
        clean = synthetic.render(fr.T_wc, SCAM, False, 30.0, 9)
        hole = np.asarray(fr.dyn_mask)
        derr = np.abs(np.asarray(depth_out) - np.asarray(clean.depth))[hole]
        # majority of the hole should be filled with background depth
        assert np.median(derr) < 0.15

    def test_region_growing_respects_depth_band(self):
        depth = jnp.full((60, 80), 2.0).at[20:40, 20:40].set(1.0)
        seeds = jnp.zeros((60, 80), bool).at[30, 30].set(True)
        region = geo.depth_region_growing(seeds, depth, 0.2, 64, 3)
        r = np.asarray(region)
        assert r[25, 25]            # grows inside the 1.0-depth block
        assert not r[10, 60]        # never jumps onto the 2.0 background
