"""Public SLAM system API — the counterpart of `ORB_SLAM2::System`.

Mirrors the reference's public surface (include/System.h, src/System.cc):
construction from a settings file, per-frame Track* entry points, trajectory
export in TUM/KITTI formats, localization-mode toggles, Reset/Shutdown.
The vocabulary argument of the reference ctor is optional here: BoW place
recognition uses an in-framework-trained vocabulary (see backend/vocabulary)
instead of the external ORBvoc.txt (which neither repo ships).
"""

from __future__ import annotations

import enum
import functools
from typing import Optional

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gdslam_tpu.config import SlamConfig
from gdslam_tpu.system import trajectory as traj
from gdslam_tpu.system.tracking import Tracking, TrackState


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


@functools.partial(jax.jit, static_argnums=(1,))
def _gray_kernel(im: jnp.ndarray, rgb_order: bool) -> jnp.ndarray:
    im = im.astype(jnp.float32)
    r, g, b = (0, 1, 2) if rgb_order else (2, 1, 0)
    return 0.299 * im[..., r] + 0.587 * im[..., g] + 0.114 * im[..., b]


def _to_gray(im: np.ndarray, rgb_order: bool = True) -> jnp.ndarray:
    """Upload + grayscale in one jitted dispatch instead of one dispatch
    per eager op (uint8 inputs upload 4x fewer bytes than float32)."""
    im = jnp.asarray(im)
    if im.ndim == 2:
        return im.astype(jnp.float32)
    return _gray_kernel(im, rgb_order)


@partial(jax.jit, static_argnums=(1,))
def _depth_to_meters(d: jnp.ndarray, scale: float) -> jnp.ndarray:
    return d.astype(jnp.float32) * scale


@partial(jax.jit, static_argnums=(11, 12))
def _gd_track_program_packed(arena, last, vel, has_vel, ref_kf, temporal,
                             packed, sem_mask, ref_gray, ref_depth,
                             ref_feats, cfg: SlamConfig, rgb_order: bool,
                             frame_id=0):
    """GD frame on a PACKED host frame: one 1-D uint8 buffer =
    [gray H*W | depth_lo H/2*W/2 | depth_hi H/2*W/2], depth at HALF
    resolution (nearest-upsampled on device).

    One packed buffer is one host->device transfer instead of two, and
    half-res depth halves its bytes (0.9 -> 0.46 MB/frame). Whether this
    still pays on a PCIe-attached GPU is ROADMAP A5. Depth quality:
    keypoint depth sampling moves by at most 1 px; real depth sensors'
    noise (sigma ~ z^2, the Mahalanobis model) dwarfs the sampling shift,
    and the Mahalanobis grid itself is quarter-res already."""
    cam = cfg.camera
    H, W = cam.height, cam.width
    H2, W2 = (H + 1) // 2, (W + 1) // 2
    gray = packed[:H * W].reshape(H, W).astype(jnp.float32)
    lo = packed[H * W:H * W + H2 * W2].reshape(H2, W2).astype(jnp.uint16)
    hi = packed[H * W + H2 * W2:].reshape(H2, W2).astype(jnp.uint16)
    dh = lo | (hi << 8)
    depth_raw = jnp.repeat(jnp.repeat(dh, 2, 0), 2, 1)[:H, :W]
    return _gd_track_program(arena, last, vel, has_vel, ref_kf, temporal,
                             gray, depth_raw, sem_mask, ref_gray, ref_depth,
                             ref_feats, cfg, rgb_order, frame_id)


@partial(jax.jit, static_argnums=(12, 13))
def _gd_track_program(arena, last, vel, has_vel, ref_kf, temporal,
                      rgb, depth_raw, sem_mask, ref_gray, ref_depth,
                      ref_feats, cfg: SlamConfig, rgb_order: bool,
                      frame_id=0):
    """The ENTIRE GD frame as ONE device program: raw-uint8 grayscale +
    raw-uint16 depth conversion -> gd_step (pose RANSAC + dense flow +
    Mahalanobis mask, geomask.py) -> Frame build with the refined mask ->
    track_frame_core. The reference runs GeoMaskMaker and Tracking as
    separate stages (Tracking.cc:212-269); dispatching them separately here
    costs ~6 host->device dispatches per frame, where one suffices.

    Returns (feats, refined_mask, gray, depth, core_out) where core_out is
    the track_frame_core tuple for Tracking.adopt_dispatched."""
    from gdslam_tpu.frontend.frame import build_frame
    from gdslam_tpu.masking.geomask import gd_step
    from gdslam_tpu.system.tracking import track_frame_core
    if rgb.ndim == 2:
        gray = rgb.astype(jnp.float32)
    else:
        gray = _gray_kernel(rgb, rgb_order)
    scale = (1.0 / cfg.camera.depth_map_factor
             if depth_raw.dtype == jnp.uint16 else 1.0)
    depth = depth_raw.astype(jnp.float32) * scale
    key = jax.random.fold_in(jax.random.PRNGKey(7), frame_id)
    feats, refined = gd_step(gray, depth, sem_mask, ref_gray, ref_depth,
                             ref_feats, key, cfg)
    frame = build_frame(feats, depth, refined, cfg.camera)
    core_out = track_frame_core(arena, last, vel, has_vel, frame, cfg,
                                ref_kf, temporal)
    return feats, refined, gray, depth, core_out


@partial(jax.jit, static_argnums=(10, 11))
def _geometry_track_program(arena, last, vel, has_vel, ref_kf, temporal,
                            rgb, depth_raw, sem_mask, db, cfg: SlamConfig,
                            rgb_order: bool, db_has=False):
    """The ENTIRE DynaSLAM geometry frame as ONE device program — the
    reference's 4-arg GrabImageRGBD body (Tracking.cc:331-369): LightTrack
    pose pre-pass -> GeometricModelCorrection (multi-view dynamic seeds +
    depth region growing + mask fusion) -> Frame rebuilt with the refined
    mask -> Track. The previous host orchestration dispatched ~5 programs
    and synchronized TWICE per frame (light_track's int(n_inl) and the
    DB-validity check). One dispatch + the pipelined commit protocol
    removes every per-frame sync.

    db_has: host-tracked "geometry ring DB has at least one entry" (the
    host performs every insert, so no device sync is needed); when False
    — or when LightTrack finds <10 inliers (Tracking.cc:660-664 refuses
    an unreliable pre-pose) — the correction is skipped and the semantic
    mask passes through unchanged.

    Returns (refined_mask, gray, depth_m, core_out)."""
    from gdslam_tpu.frontend import extractor
    from gdslam_tpu.frontend.frame import build_frame
    from gdslam_tpu.masking import geometry as geom
    from gdslam_tpu.system.tracking import (track_frame_core,
                                            track_motion_model)
    from gdslam_tpu.core import camera as cam_ops
    from gdslam_tpu.core import lie
    cam = cfg.camera
    if rgb.ndim == 2:
        gray = rgb.astype(jnp.float32)
    else:
        gray = _gray_kernel(rgb, rgb_order)
    scale = (1.0 / cam.depth_map_factor
             if depth_raw.dtype == jnp.uint16 else 1.0)
    depth = depth_raw.astype(jnp.float32) * scale
    feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
    frame0 = build_frame(feats, depth, sem_mask, cam)
    # LightTrack (Tracking.cc:654-760): pure pose pre-pass on the
    # semantic-masked frame; no tracker state is touched.
    lf = last.frame
    pc = cam_ops.backproject(lf.uv, lf.depth, cam)
    pw_depth = lie.se3_apply(lie.se3_inverse(last.T_cw), pc)
    has_pt = last.assoc >= 0
    pts_w = jnp.where(has_pt[:, None],
                      arena.pt_pos[jnp.where(has_pt, last.assoc, 0)],
                      pw_depth)
    T_pred = jnp.where(has_vel, vel @ last.T_cw, last.T_cw)
    T_lt, a_lt, n_lt, _ = track_motion_model(last, pts_w, frame0, T_pred,
                                             cfg)

    def wide_retry(_):
        return track_motion_model(last, pts_w, frame0, last.T_cw, cfg,
                                  radius_px=30.0)

    T_lt, a_lt, n_lt, _ = jax.lax.cond(
        n_lt < 10, wide_retry,
        lambda _: (T_lt, a_lt, n_lt, jnp.asarray(0, n_lt.dtype)), None)
    # GeometricModelCorrection (Geometry.cc:29-40) under the provisional
    # pose; gated by LightTrack success + DB non-emptiness.
    grown = geom.correction_dynamic_mask(db, depth, T_lt, cfg)
    ok = (n_lt >= 10) & jnp.asarray(db_has)
    refined = jnp.where(ok, geom.combine_masks(sem_mask, grown), sem_mask)
    # Keypoint-level re-cull over the SAME features (the reference
    # re-extracts only because its masking is image-level, Tracking.cc:312).
    frame = build_frame(feats, depth, refined, cam)
    core_out = track_frame_core(arena, last, vel, has_vel, frame, cfg,
                                ref_kf, temporal)
    return refined, gray, depth, core_out


class System:
    """SLAM system with the reference's System API surface
    (System::TrackRGBD System.cc:157-312, SaveTrajectoryTUM :418-476,
    SaveKeyFrameTrajectoryTUM :479-513, SaveTrajectoryKITTI :543-596)."""

    def __init__(self, settings: SlamConfig | str, sensor: Sensor = Sensor.RGBD,
                 use_viewer: bool = False, vocabulary: Optional[str] = None,
                 kmax: int = 512, pmax: int = 65536, pipeline: bool = False):
        if isinstance(settings, str):
            settings = SlamConfig.from_opencv_yaml(settings)
        self.cfg = settings
        self.sensor = sensor
        self.tracker = Tracking(settings, kmax=kmax, pmax=pmax,
                                pipeline=pipeline)
        self._localization_only = False
        self._geo = None  # lazily-constructed GeoMaskMaker (TrackRGBD_GD)
        self._geometry = None  # lazily-constructed Geometry (DynaSLAM path)
        self._last_refined_mask = None
        # Geometry ring-DB bookkeeping (GeometricModelUpdateDB,
        # Geometry.cc:48-53): with a pipelined tracker the keyframe decision
        # lags the frame by up to commit_every frames, so candidate frames
        # are cached (device arrays — cheap references) and inserted into
        # the DB when their keyframe materializes at commit time, with the
        # arena's refined pose.
        self._geo_db_count = 0      # host mirror of #inserted DB frames
        self._geo_kf_seen = 0       # keyframes already reconciled
        self._geo_frame_cache = {}  # timestamp -> (gray, depth, mask, rgb)
        self._geo_pending_frame = None
        self._ones_mask = None  # cached all-static mask (device)
        self._vocab = None
        if vocabulary is not None:
            from gdslam_tpu.backend import vocabulary as voc_mod
            from gdslam_tpu.backend.loop_closing import LoopCloser
            if isinstance(vocabulary, str):
                self._vocab = voc_mod.load(vocabulary)
            else:
                self._vocab = vocabulary
            self.tracker.loop_closer = LoopCloser(settings, self._vocab, kmax)
            # bFixScale (Sim3Solver.h:20 / System.cc loop-closer ctor):
            # metric-depth sensors fix the Sim3 scale; monocular leaves it
            # free so loop closure can correct scale drift.
            self.tracker.loop_closer.fix_scale = sensor != Sensor.MONOCULAR
        self.tracker.sensor_mono = sensor == Sensor.MONOCULAR

    def _to_depth(self, depth) -> jnp.ndarray:
        """Upload depth and convert to float meters ON DEVICE. uint16 input
        is raw sensor units scaled by 1/DepthMapFactor (the reference's
        GrabImageRGBD convertTo contract) — uploading raw halves the bytes
        of a host-side float32 conversion."""
        d = jnp.asarray(depth)
        if d.dtype == jnp.float32:
            return d
        scale = 1.0 / self.cfg.camera.depth_map_factor \
            if d.dtype == jnp.uint16 else 1.0
        return _depth_to_meters(d, scale)

    # ------------------------------------------------------------------ track
    def track_rgbd(self, rgb: np.ndarray, depth: np.ndarray,
                   mask: Optional[np.ndarray], timestamp: float,
                   use_geometry: bool = False) -> np.ndarray:
        """TrackRGBD (System.cc:157-312): depth in meters (already scaled by
        DepthMapFactor), mask 1=static. Returns T_cw 4x4.

        With use_geometry=True this is the DynaSLAM path (the reference's
        4-arg GrabImageRGBD, Tracking.cc:331-369): LightTrack pose pre-pass ->
        Geometry::GeometricModelCorrection refines the semantic mask with
        multi-view geometric dynamic detection -> frame rebuilt with the
        refined mask -> Track -> GeometricModelUpdateDB. (The 7-arg form with
        background inpainting is track_rgbd_geom.)"""
        gray = _to_gray(rgb, self.cfg.camera.rgb == 1)
        depth = self._to_depth(depth)
        if mask is None:
            mask = jnp.ones(gray.shape, jnp.float32)
        mask = jnp.asarray(mask, jnp.float32)
        if not use_geometry:
            return self.tracker.process(gray, depth, mask, timestamp)
        T, _ = self._track_rgbd_geometry(gray, depth, mask, timestamp)
        # the inpainting ring stores color; with a single-channel input the
        # gray image stands in for all three channels
        rgb_j = jnp.asarray(rgb, jnp.float32)
        if rgb_j.ndim == 2:
            rgb_j = jnp.broadcast_to(rgb_j[..., None], rgb_j.shape + (3,))
        self._geo_note_frame(rgb_j)
        self._geo_sync_db()
        return T

    def track_rgbd_geom(self, rgb: np.ndarray, depth: np.ndarray,
                        mask: Optional[np.ndarray], timestamp: float):
        """The reference's 7-arg TrackRGBD (System.cc:157-207 ->
        GrabImageRGBD, Tracking.cc:271-329): geometric mask correction +
        background inpainting. Returns (T_cw, rgb_out, depth_out, mask_out)
        — the imRGBOut/imDOut/maskOut output arguments."""
        gray = _to_gray(rgb, self.cfg.camera.rgb == 1)
        depth = self._to_depth(depth)
        rgb_j = jnp.asarray(rgb).astype(jnp.float32)
        if mask is None:
            mask = jnp.ones(gray.shape, jnp.float32)
        mask = jnp.asarray(mask, jnp.float32)
        T, refined = self._track_rgbd_geometry(gray, depth, mask, timestamp)
        rgb_out, depth_out = self._geometry.inpaint_frames(
            rgb_j, depth, refined, jnp.asarray(np.asarray(T)))
        self._geo_note_frame(rgb_j)
        self._geo_sync_db()
        return T, np.asarray(rgb_out), np.asarray(depth_out), \
            np.asarray(refined)

    def _track_rgbd_geometry(self, gray, depth, sem_mask, timestamp):
        """Shared body of the DynaSLAM RGB-D entry point: LightTrack ->
        GeometricModelCorrection -> masked Frame -> Track (Tracking.cc:
        271-329, 301-312). Returns (T_cw, refined_mask).

        With a pipelined tracker in steady state the whole frame runs as
        ONE device dispatch (_geometry_track_program); otherwise the staged
        host orchestration below is used (init frames, non-pipelined
        trackers, tests)."""
        from gdslam_tpu.frontend import extractor
        from gdslam_tpu.frontend.frame import build_frame
        from gdslam_tpu.system.tracking import TrackState
        if self._geometry is None:
            from gdslam_tpu.masking.geometry import Geometry
            self._geometry = Geometry(self.cfg)
        cfg = self.cfg
        cam = cfg.camera
        tr = self.tracker
        if tr.pipeline and tr.last is not None and tr.state == TrackState.OK:
            has_vel = tr.velocity is not None
            vel = tr.velocity if has_vel else tr._eye4
            refined, gray_d, depth_m, core_out = _geometry_track_program(
                tr.arena, tr.last, vel, tr._jbool(has_vel), tr._ref_kf_dev,
                tr._jbool(not tr.mapping_enabled), gray, depth, sem_mask,
                self._geometry.db, cfg, self.cfg.camera.rgb == 1,
                tr._jbool(self._geo_db_count > 0))
            T = tr.adopt_dispatched(core_out, timestamp)
            self._last_refined_mask = refined
            self._geo_pending_frame = (float(timestamp), gray_d, depth_m,
                                       refined)
            return T, refined
        feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
        frame = build_frame(feats, depth, sem_mask, cam)
        refined = sem_mask
        ok, T_pred = self.tracker.light_track(frame)
        if ok:
            refined = self._geometry.geometric_model_correction(
                depth, T_pred, sem_mask)
            # Rebuild with the refined mask: keypoint-level culling over the
            # SAME features (the reference re-extracts only because its
            # masking is image-level, Tracking.cc:312; SURVEY §7.1).
            frame = build_frame(feats, depth, refined, cam)
        T = self.tracker._process_built_frame(frame, timestamp)
        self._last_refined_mask = refined
        self._geo_pending_frame = (float(timestamp), gray, depth, refined)
        return T, refined

    def _geo_note_frame(self, rgb):
        """Attach the color plane to the frame recorded by
        _track_rgbd_geometry and move it into the keyframe-candidate cache."""
        if self._geo_pending_frame is None:
            return
        ts, gray, depth, mask = self._geo_pending_frame
        self._geo_pending_frame = None
        self._geo_frame_cache[ts] = (gray, depth, mask, rgb)
        if len(self._geo_frame_cache) > 24:
            for k in list(self._geo_frame_cache)[:-24]:
                del self._geo_frame_cache[k]

    def _geo_sync_db(self):
        """Insert cached frames whose keyframe has materialized (possibly a
        few frames late under the pipelined commit protocol) into the
        geometry ring DB with the keyframe's arena pose."""
        if self._geometry is None:
            return
        from gdslam_tpu.masking.geometry import db_insert
        tr = self.tracker
        kts = tr.kf_timestamps
        if len(kts) < self._geo_kf_seen:
            self._geo_kf_seen = 0   # tracker reset/compaction shrank the list
        for slot in range(self._geo_kf_seen, len(kts)):
            entry = self._geo_frame_cache.pop(kts[slot], None)
            if entry is not None:
                gray, depth, mask, rgb = entry
                self._geometry.db = db_insert(
                    self._geometry.db, gray, depth, mask, rgb,
                    tr.arena.kf_pose[slot])
                self._geo_db_count += 1
        self._geo_kf_seen = len(kts)

    def _update_geometry_db(self, gray, depth, mask, rgb):
        """GeometricModelUpdateDB (Tracking.cc:262, 326 -> Geometry.cc:48-53):
        insert the frame into the 20-slot ring DB if it became a keyframe."""
        if self._geometry is None:
            from gdslam_tpu.masking.geometry import Geometry
            self._geometry = Geometry(self.cfg)
        tr = self.tracker
        is_kf = tr.state == TrackState.OK and tr.frames_since_kf == 0
        self._geometry.update_db(gray, depth, mask, rgb,
                                 tr.last.T_cw if tr.last is not None
                                 else jnp.eye(4),
                                 is_keyframe=is_kf)
        if is_kf:
            self._geo_db_count += 1

    def track_rgbd_gd(self, rgb: np.ndarray, depth: np.ndarray,
                      mask: Optional[np.ndarray], timestamp: float,
                      inpaint: bool = False):
        """TrackRGBD_GD (System.cc:209-260): runs the dense-scene-flow
        GeoMaskMaker to refine the semantic mask before tracking
        (Tracking::GrabImageRGBD_GD, Tracking.cc:212-269), then updates the
        geometry ring DB (Tracking.cc:262). Returns (T_cw, refined_mask);
        with inpaint=True additionally runs background inpainting
        (Tracking.cc:259) and returns (T_cw, refined_mask, rgb_out,
        depth_out) — the reference's imRGBOut/imDOut output arguments.

        `rgb` may be a single-channel uint8 GRAY image when inpaint=False:
        the GD path itself needs no color (gray flow + depth), and a
        host-side grayscale conversion cuts the per-frame upload 3x
        (921 KB rgb -> 307 KB gray)."""
        if inpaint and getattr(rgb, "ndim", 3) != 3:
            raise ValueError("inpaint=True needs a 3-channel rgb input "
                             "(the inpainted output is color imagery)")
        from gdslam_tpu.frontend.frame import build_frame
        from gdslam_tpu.masking.geomask import GeoMaskMaker
        if self._geo is None:
            self._geo = GeoMaskMaker(self.cfg)
        tr = self.tracker
        # Fast path: warm ring + initialized pipelined tracker + no inpaint
        # output needed -> the whole frame is ONE device dispatch.
        if (not inpaint and tr.pipeline and tr.last is not None
                and tr.state == TrackState.OK and self._geo.warm):
            geo = self._geo
            ref_gray, ref_depth, ref_feats = geo.ref_for_next()
            if mask is None:
                if self._ones_mask is None:
                    cam = self.cfg.camera
                    self._ones_mask = jnp.ones((cam.height, cam.width),
                                               jnp.float32)
                sem = self._ones_mask
            else:
                sem = jnp.asarray(mask, jnp.float32)
            has_vel = tr.velocity is not None
            vel = tr.velocity if has_vel else tr._eye4
            if (isinstance(rgb, np.ndarray) and rgb.dtype == np.uint8
                    and rgb.ndim == 2 and isinstance(depth, np.ndarray)
                    and depth.dtype == np.uint16):
                # host uint8-gray + uint16-depth (the CLI contract): ship
                # gray + HALF-RES depth in ONE 1-D uint8 buffer (see
                # _gd_track_program_packed for the measured rationale)
                dh = depth[::2, ::2]
                packed = np.concatenate(
                    [rgb.reshape(-1), (dh & 0xff).astype(np.uint8).reshape(-1),
                     (dh >> 8).astype(np.uint8).reshape(-1)])
                feats, refined, gray, depth_m, core_out = \
                    _gd_track_program_packed(
                        tr.arena, tr.last, vel, tr._jbool(has_vel),
                        tr._ref_kf_dev, tr._jbool(not tr.mapping_enabled),
                        jnp.asarray(packed), sem, ref_gray, ref_depth,
                        ref_feats, self.cfg, self.cfg.camera.rgb == 1,
                        tr.frame_id)
            else:
                feats, refined, gray, depth_m, core_out = _gd_track_program(
                    tr.arena, tr.last, vel, tr._jbool(has_vel),
                    tr._ref_kf_dev, tr._jbool(not tr.mapping_enabled),
                    jnp.asarray(rgb), jnp.asarray(depth), sem, ref_gray,
                    ref_depth, ref_feats, self.cfg,
                    self.cfg.camera.rgb == 1, tr.frame_id)
            geo.push(gray, depth_m, feats)
            T = tr.adopt_dispatched(core_out, timestamp)
            # refined stays a device array (see below).
            return T, refined
        gray = _to_gray(rgb, self.cfg.camera.rgb == 1)
        depth = self._to_depth(depth)
        if mask is None:
            mask = jnp.ones(gray.shape, jnp.float32)
        mask = jnp.asarray(mask, jnp.float32)
        self._geo.add_new_image(gray, depth, mask)
        refined = self._geo.get_mask(mask)
        # Reuse the GD stage's extraction: the refined mask culls keypoints
        # at the Frame level, so no re-extraction is needed (the reference
        # re-extracts because its masking is image-level, Tracking.cc:252;
        # SURVEY §7.1 calls out this collapse as behavior-equivalent).
        frame = build_frame(self._geo.last_feats, depth, refined,
                            self.cfg.camera)
        T = self.tracker._process_built_frame(frame, timestamp)
        if not inpaint:
            # refined stays a device array: materializing the [H, W] mask
            # costs a round trip + ~1.2 MB transfer per frame;
            # np.asarray(refined) converts on demand.
            return T, refined
        rgb_j = jnp.asarray(rgb).astype(jnp.float32)
        if self._geometry is None:
            from gdslam_tpu.masking.geometry import Geometry
            self._geometry = Geometry(self.cfg)
        rgb_out, depth_out = self._geometry.inpaint_frames(
            rgb_j, depth, refined, jnp.asarray(np.asarray(T)))
        self._update_geometry_db(gray, depth, refined, rgb_j)
        return T, np.asarray(refined), np.asarray(rgb_out), \
            np.asarray(depth_out)

    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float, mask=None) -> np.ndarray:
        """TrackStereo (System.cc:104): rectified stereo pair."""
        gl = _to_gray(left, self.cfg.camera.rgb == 1)
        gr = _to_gray(right, self.cfg.camera.rgb == 1)
        return self.tracker.process_stereo(gl, gr, mask, timestamp)

    def track_monocular(self, image: np.ndarray, timestamp: float) -> np.ndarray:
        """TrackMonocular (System.cc:314)."""
        gray = _to_gray(image, self.cfg.camera.rgb == 1)
        return self.tracker.process_mono(gray, timestamp)

    # ------------------------------------------------------------------ modes
    def activate_localization_mode(self):
        """System::ActivateLocalizationMode (System.cc:366): stop map growth;
        tracking continues against the frozen map."""
        self._localization_only = True
        self.tracker.mapping_enabled = False

    def deactivate_localization_mode(self):
        self._localization_only = False
        self.tracker.mapping_enabled = True

    def reset(self):
        """System::Reset (System.cc:391). Preserves the pipeline flag and
        the loop closer (the reference's Reset keeps both threads alive and
        only clears their state, System.cc:391-395)."""
        old = self.tracker
        self.tracker = Tracking(self.cfg, kmax=old.arena.kmax,
                                pmax=old.arena.pmax, pipeline=old.pipeline)
        self.tracker.commit_every = old.commit_every
        if old.loop_closer is not None:
            old.loop_closer.reset()
            self.tracker.loop_closer = old.loop_closer
        self._geo = None
        self._geometry = None
        self._last_refined_mask = None
        self._geo_db_count = 0
        self._geo_kf_seen = 0
        self._geo_frame_cache = {}
        self._geo_pending_frame = None

    def shutdown(self):
        """System::Shutdown (System.cc:397-416): drain the in-flight
        pipeline (the analogue of joining the worker threads)."""
        self.tracker.flush()

    # ------------------------------------------------------------------ state
    @property
    def tracking_state(self) -> TrackState:
        return self.tracker.state

    @property
    def map_point_count(self) -> int:
        return int(jnp.sum(self.tracker.arena.pt_valid))

    @property
    def keyframe_count(self) -> int:
        return int(jnp.sum(self.tracker.arena.kf_valid))

    # ----------------------------------------------------------------- export
    def save_map(self, path: str):
        """Serialize the full map state (the reference's SaveMap TODO,
        System.h:113-115, realized)."""
        from gdslam_tpu.utils.checkpoint import save_map
        self.tracker.flush()
        save_map(self.tracker.arena, path,
                 kf_timestamps=self.tracker.kf_timestamps)

    def load_map(self, path: str):
        from gdslam_tpu.utils.checkpoint import load_map_with_timestamps
        self.tracker.arena, self.tracker.kf_timestamps = \
            load_map_with_timestamps(path)

    def save_trajectory_tum(self, path: str):
        traj.save_tum(path, self.tracker.camera_trajectory())

    def save_keyframe_trajectory_tum(self, path: str):
        traj.save_tum(path, self.tracker.keyframe_trajectory())

    def save_trajectory_kitti(self, path: str):
        traj.save_kitti(path, self.tracker.camera_trajectory())
