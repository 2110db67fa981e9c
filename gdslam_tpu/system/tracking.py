"""Tracking front-end: the per-frame state machine.

Re-design of the reference Tracking class (Tracking.cc:408-652 `Track`,
762-815 `StereoInitialization`, 1196-1257 `TrackWithMotionModel`,
1259-1303 `TrackLocalMap`, 1306-1470 keyframe decision/creation).

Architecture: a thin host state machine drives a handful of jitted device
programs; all per-frame math (extraction, matching, pose GN, map updates)
runs on device against the fixed-shape MapArena. Host branching happens only
at frame granularity (tracking-ok?, need-keyframe?), mirroring the
reference's own frame-level control flow.
"""

from __future__ import annotations

import enum
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gdslam_tpu.backend import map_arena as ma
from gdslam_tpu.backend import optimizer
from gdslam_tpu.config import SlamConfig
from gdslam_tpu.core import camera as cam_ops
from gdslam_tpu.core import lie
from gdslam_tpu.frontend import extractor, matcher
from gdslam_tpu.frontend.frame import Frame, build_frame

LOCAL_POINT_CAP = 4096   # dense local-map candidate budget


@jax.jit
def _dense_ratio_matches(desc_a, valid_a, desc_b, valid_b):
    """Brute-force Hamming matching with 0.75 ratio test — the vocabulary-
    free stand-in for SearchByBoW during relocalization (per-keypoint best
    match in the candidate keyframe)."""
    from gdslam_tpu.ops import hamming
    from gdslam_tpu.ops import orb as orb_ops
    D = hamming.hamming_matrix(orb_ops.descriptors_pm1(desc_a, valid_a),
                               orb_ops.descriptors_pm1(desc_b, valid_b))
    cost = jnp.where(valid_a[:, None] & valid_b[None, :], D, 1 << 20)
    best, second, idx = hamming.best_two(cost, axis=1)
    good = (best < 50) & (best.astype(jnp.float32) <
                          0.75 * jnp.minimum(second, 1 << 20).astype(jnp.float32))
    return jnp.where(good, idx, -1), jnp.sum(good)


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class FrameState(NamedTuple):
    """Device-resident last-frame context."""

    frame: Frame
    T_cw: jnp.ndarray       # [4, 4]
    assoc: jnp.ndarray      # [N] int32 map-point id per keypoint (-1)


def _K(cfg: SlamConfig):
    c = cfg.camera
    return (c.fx, c.fy, c.cx, c.cy)


def _inv_sigma2(level: jnp.ndarray, scale: float) -> jnp.ndarray:
    return 1.0 / (scale ** (2.0 * level.astype(jnp.float32)))


# ----------------------------------------------------------------------------
# Device programs
# ----------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(3,))
def stereo_initialize(arena: ma.MapArena, frame: Frame, T_cw: jnp.ndarray,
                      cfg: SlamConfig):
    """First keyframe + map points from every depth-valid keypoint
    (StereoInitialization, Tracking.cc:762-815)."""
    arena, assoc = _insert_keyframe(arena, frame, T_cw,
                                    -jnp.ones(frame.uv.shape[0], jnp.int32),
                                    jnp.asarray(0.0), cfg, max_depth=1e9)
    return arena, assoc


def _insert_keyframe(arena: ma.MapArena, frame: Frame, T_cw: jnp.ndarray,
                     assoc: jnp.ndarray, timestamp, cfg: SlamConfig,
                     max_depth: float | None = None):
    """Insert keyframe + create map points for unmatched close-depth
    keypoints (CreateNewKeyFrame, Tracking.cc:1392-1470)."""
    cam = cfg.camera
    kf_id = arena.n_kf
    if max_depth is None:
        max_depth = cam.bf * cam.th_depth / cam.fx  # mThDepth (Tracking.cc:120)
    T_wc = lie.se3_inverse(T_cw)
    # New points: valid kp with depth, unassociated, and either close-range
    # or among the 100 nearest — the reference creates the 100 nearest
    # regardless of the depth threshold (CreateNewKeyFrame depth-sorted loop,
    # Tracking.cc:1392-1470).
    eligible = frame.valid & (frame.depth > 0) & (assoc < 0)
    depth_rank = jnp.argsort(jnp.argsort(
        jnp.where(eligible, frame.depth, jnp.inf)))
    create = eligible & ((frame.depth < max_depth) | (depth_rank < 100))
    order = jnp.cumsum(create.astype(jnp.int32)) - 1
    # Capacity guard: without it, slots past pmax silently alias slot pmax-1
    # through clamp-gathers and corrupt associations on long sequences.
    create = create & (arena.n_pt + order < arena.pmax)
    slot = jnp.where(create, arena.n_pt + order, 0)
    pc = cam_ops.backproject(frame.uv, frame.depth, cam)
    pw = lie.se3_apply(T_wc, pc)
    ow = T_wc[:3, 3]
    dvec = pw - ow
    dist = jnp.linalg.norm(dvec, axis=1)
    normal = dvec / jnp.maximum(dist[:, None], 1e-9)
    sf = float(cfg.orb.scale_factor)
    level_sf = sf ** frame.level.astype(jnp.float32)
    max_d = dist * level_sf
    min_d = max_d / (sf ** (cfg.orb.n_levels - 1))

    def scatter(dst, src):
        return dst.at[slot].set(jnp.where(
            create.reshape((-1,) + (1,) * (src.ndim - 1)), src, dst[slot]))

    arena = arena._replace(
        pt_pos=scatter(arena.pt_pos, pw),
        pt_desc=scatter(arena.pt_desc, frame.desc),
        pt_normal=scatter(arena.pt_normal, normal),
        pt_min_dist=scatter(arena.pt_min_dist, min_d),
        pt_max_dist=scatter(arena.pt_max_dist, max_d),
        pt_valid=arena.pt_valid.at[slot].set(
            jnp.where(create, True, arena.pt_valid[slot])),
        pt_ref_kf=scatter(arena.pt_ref_kf, jnp.full_like(slot, kf_id)),
        n_pt=jnp.minimum(arena.n_pt + jnp.sum(create), arena.pmax),
    )
    new_assoc = jnp.where(create, slot.astype(jnp.int32), assoc)
    obs_row = jnp.where(frame.valid, new_assoc, -1)
    arena = arena._replace(
        kf_pose=arena.kf_pose.at[kf_id].set(T_cw),
        kf_valid=arena.kf_valid.at[kf_id].set(True),
        kf_time=arena.kf_time.at[kf_id].set(timestamp),
        kf_uv=arena.kf_uv.at[kf_id].set(frame.uv),
        kf_ur=arena.kf_ur.at[kf_id].set(frame.ur),
        kf_depth=arena.kf_depth.at[kf_id].set(frame.depth),
        kf_level=arena.kf_level.at[kf_id].set(frame.level),
        kf_angle=arena.kf_angle.at[kf_id].set(frame.angle),
        kf_desc=arena.kf_desc.at[kf_id].set(frame.desc),
        kf_kp_valid=arena.kf_kp_valid.at[kf_id].set(frame.valid),
        kf_obs=arena.kf_obs.at[kf_id].set(obs_row),
        n_kf=arena.n_kf + 1,
    )
    # observation counts for matched existing points
    obs_inc = (obs_row >= 0)
    arena = arena._replace(pt_n_obs=arena.pt_n_obs.at[
        jnp.where(obs_inc, obs_row, arena.pmax - 1)].add(obs_inc.astype(jnp.int32)))
    arena = ma.update_covisibility(arena, kf_id)
    return arena, new_assoc


insert_keyframe = jax.jit(_insert_keyframe, static_argnums=(5,))


@partial(jax.jit, static_argnums=(5, 6, 7))
def keyframe_program(arena: ma.MapArena, frame: Frame, T_cw: jnp.ndarray,
                     assoc: jnp.ndarray, timestamp, cfg: SlamConfig,
                     use_triangulation: bool, use_ba: bool):
    """The ENTIRE keyframe-insertion pipeline as ONE device program:
    proactive fuse -> insert -> epipolar CreateNewMapPoints -> duplicate
    fusion (Replace) -> descriptor/normal refresh -> point culling ->
    local BA -> reference-match statistic. One dispatch instead of ~8, so
    the keyframe pays one host<->device round trip instead of one per stage.

    Returns (arena, assoc, T_refined, ref_matches)."""
    from gdslam_tpu.backend import ba as ba_mod
    from gdslam_tpu.backend import mapping
    assoc = fuse_associate(arena, frame, T_cw, assoc, cfg)
    arena, assoc = _insert_keyframe(arena, frame, T_cw, assoc, timestamp, cfg)
    kf_id = arena.n_kf - 1
    if use_triangulation:
        arena = mapping.create_new_map_points(arena, kf_id, cfg)
        arena, assoc = mapping.fuse_into_keyframe(arena, kf_id, cfg)
    arena = mapping.refresh_points(arena, kf_id, cfg)
    arena = cull_points(arena)
    if use_ba:
        prob = ba_mod.build_problem(arena, kf_id, cfg)
        arena, _ = ba_mod.run_local_ba(arena, prob, cfg, 5, 5)
        T_out = arena.kf_pose[kf_id]
    else:
        T_out = T_cw
    n_kf = arena.n_kf
    min_obs = jnp.where(n_kf > 2, 3, jnp.where(n_kf == 2, 2, 1))
    ref_m = ref_tracked_points(arena, kf_id, min_obs)
    return arena, assoc, T_out, ref_m


@partial(jax.jit, static_argnums=(4,))
def fuse_associate(arena: ma.MapArena, frame: Frame, T_cw: jnp.ndarray,
                   assoc: jnp.ndarray, cfg: SlamConfig):
    """Associate still-unmatched keypoints to existing map points with a
    wider window before creating new points — the role of LocalMapping's
    SearchInNeighbors / ORBmatcher::Fuse duplicate merging
    (LocalMapping.cc:454-535, ORBmatcher.cc:825-977), done proactively at
    keyframe insertion so duplicates are never created."""
    cam = cfg.camera
    sfs = extractor.scale_factors(cfg.orb)
    uv_p, level_p, radius_p, vis = matcher.project_for_search(
        arena.pt_pos, arena.pt_valid, T_cw, _K(cfg), (cam.width, cam.height),
        sfs, pt_max_dist=arena.pt_max_dist, pt_normal=arena.pt_normal,
        base_radius=6.0)
    cap = min(LOCAL_POINT_CAP, arena.pmax)
    score = jnp.where(vis, 1 + arena.pt_n_obs, 0)
    # exact selection; float32 (small integer scores, exact) is XLA:CPU's
    # fast top_k path
    _, cand_ids = jax.lax.top_k(score.astype(jnp.float32), cap)
    cand_ids = cand_ids.astype(jnp.int32)
    cvalid = vis[cand_ids]
    from gdslam_tpu.ops import orb as orb_ops
    kp_free = frame.valid & (assoc < 0)
    res = matcher.match_candidates(
        uv_p[cand_ids], cvalid,
        orb_ops.descriptors_pm1(arena.pt_desc[cand_ids], cvalid),
        level_p[cand_ids], jnp.zeros(cap), radius_p[cand_ids],
        frame.uv, kp_free,
        orb_ops.descriptors_pm1(frame.desc, kp_free),
        frame.level, frame.angle,
        th_hamming=matcher.TH_LOW, level_slack=1, use_rotation=False)
    new_match = res.point_idx >= 0
    return jnp.where(new_match,
                     cand_ids[jnp.where(new_match, res.point_idx, 0)]
                     .astype(jnp.int32), assoc)


@jax.jit
def cull_points(arena: ma.MapArena):
    """MapPointCulling (LocalMapping.cc:170-206): drop points whose
    found/visible ratio < 0.25, or that are >=3 keyframes old with fewer
    than 2 keyframe observations."""
    age = arena.n_kf - arena.pt_ref_kf
    ratio = arena.pt_found.astype(jnp.float32) / \
        jnp.maximum(arena.pt_visible, 1).astype(jnp.float32)
    seen_enough = arena.pt_visible >= 8  # don't judge brand-new points
    bad = (seen_enough & (ratio < 0.25)) | ((age >= 3) & (arena.pt_n_obs < 2))
    return arena._replace(pt_valid=arena.pt_valid & ~bad)


@jax.jit
def ref_tracked_points(arena: ma.MapArena, kf_id, min_obs) -> jnp.ndarray:
    """KeyFrame::TrackedMapPoints(minObs) (KeyFrame.cc): #keypoints of kf_id
    whose map point has >= min_obs observations."""
    obs = arena.kf_obs[kf_id]
    has = obs >= 0
    n_obs = arena.pt_n_obs[jnp.where(has, obs, 0)]
    ok = has & arena.pt_valid[jnp.where(has, obs, 0)] & (n_obs >= min_obs)
    return jnp.sum(ok)


@partial(jax.jit, static_argnums=(4, 5))
def track_motion_model(last: FrameState, last_depthpts_w: jnp.ndarray,
                       frame: Frame, T_pred: jnp.ndarray, cfg: SlamConfig,
                       radius_px: float = 15.0, temporal_points=True):
    """Frame-to-frame tracking (TrackWithMotionModel, Tracking.cc:1196-1257).

    Candidates are the last frame's keypoints with a map-point association;
    with temporal_points also those with valid depth (the reference's
    temporal 'visual odometry' points, UpdateLastFrame Tracking.cc:
    1056-1125 — created ONLY in localization mode, Tracking.cc:1075). In
    mapping mode anchoring on last-frame backprojections is actively
    harmful: their world positions inherit the last pose's error, so the
    estimate adopts the constant-velocity prediction and per-step error
    compounds geometrically (observed: golden-ratio error growth on a
    rotation-dominant trajectory). Map points are BA-anchored and break the
    feedback loop. Matching = dense projection search with radius
    15*scale^level; then pose GN.
    """
    cam = cfg.camera
    K = _K(cfg)
    sf = float(cfg.orb.scale_factor)
    lf = last.frame
    temporal = jnp.asarray(temporal_points)
    cand_valid = lf.valid & ((last.assoc >= 0) |
                             (temporal & (lf.depth > 0)))
    # Project candidate world points with the predicted pose.
    uv_proj, zc = cam_ops.project(lie.se3_apply(T_pred, last_depthpts_w), cam)
    in_img = (uv_proj[:, 0] >= 0) & (uv_proj[:, 0] < cam.width) & \
             (uv_proj[:, 1] >= 0) & (uv_proj[:, 1] < cam.height) & (zc > 0)
    cand_valid = cand_valid & in_img
    radius = radius_px * sf ** lf.level.astype(jnp.float32)

    from gdslam_tpu.ops import orb as orb_ops
    cand_pm1 = orb_ops.descriptors_pm1(lf.desc, cand_valid)
    kp_pm1 = orb_ops.descriptors_pm1(frame.desc, frame.valid)
    res = matcher.match_candidates(
        uv_proj, cand_valid, cand_pm1, lf.level, lf.angle, radius,
        frame.uv, frame.valid, kp_pm1, frame.level, frame.angle,
        th_hamming=matcher.TH_HIGH, level_slack=1, use_rotation=True)

    matched = res.point_idx >= 0
    cand_row = jnp.where(matched, res.point_idx, 0)
    pw = last_depthpts_w[cand_row]
    obs = optimizer.PoseObs(
        pw=jnp.where(matched[:, None], pw, 0.0),
        uv=frame.uv,
        ur=frame.ur,
        inv_sigma2=_inv_sigma2(frame.level, sf),
        valid=matched,
    )
    T, inl, n_inl = optimizer.pose_optimization(T_pred, obs, K, cam.bf)
    # Map-point association carried to current frame (temporal points get -1).
    new_assoc = jnp.where(inl & matched, last.assoc[cand_row], -1)
    return T, new_assoc, n_inl, res.n_matches


@partial(jax.jit, static_argnums=(3,))
def track_local_map(arena: ma.MapArena, frame: Frame, T: jnp.ndarray,
                    cfg: SlamConfig, assoc: jnp.ndarray):
    """Refine pose against the local map (TrackLocalMap, Tracking.cc:
    1259-1303 + SearchLocalPoints 1472-1522).

    Local candidates = top-LOCAL_POINT_CAP valid points passing the frustum
    test at pose T; already-matched keypoints keep their motion-model match.
    """
    cam = cfg.camera
    K = _K(cfg)
    sf = float(cfg.orb.scale_factor)
    sfs = extractor.scale_factors(cfg.orb)

    # th=3 for RGB-D (SearchLocalPoints, Tracking.cc:1480-1492): a wide
    # search basin lets the map pull the pose back when the motion-model
    # estimate has drifted a few pixels; with a tight radius the error
    # compounds instead (matches confirm the wrong prediction).
    uv_p, level_p, radius_p, vis = matcher.project_for_search(
        arena.pt_pos, arena.pt_valid, T, K, (cam.width, cam.height), sfs,
        pt_max_dist=arena.pt_max_dist, pt_normal=arena.pt_normal,
        base_radius=12.0)
    # Budgeted candidate set: prefer high-observation points.
    cap = min(LOCAL_POINT_CAP, arena.pmax)
    score = jnp.where(vis, 1 + arena.pt_n_obs, 0)
    # exact selection; float32 (small integer scores, exact) is XLA:CPU's
    # fast top_k path
    _, cand_ids = jax.lax.top_k(score.astype(jnp.float32), cap)
    cand_ids = cand_ids.astype(jnp.int32)
    cvalid = vis[cand_ids]

    from gdslam_tpu.ops import orb as orb_ops
    cand_pm1 = orb_ops.descriptors_pm1(arena.pt_desc[cand_ids], cvalid)
    kp_free = frame.valid & (assoc < 0)
    kp_pm1 = orb_ops.descriptors_pm1(frame.desc, kp_free)
    # angles unknown for map points -> disable rotation check here
    res = matcher.match_candidates(
        uv_p[cand_ids], cvalid, cand_pm1, level_p[cand_ids],
        jnp.zeros(cap), radius_p[cand_ids],
        frame.uv, kp_free, kp_pm1, frame.level, frame.angle,
        th_hamming=matcher.TH_HIGH, level_slack=1, use_rotation=False,
        nn_ratio=0.8)
    new_match = res.point_idx >= 0
    merged_assoc = jnp.where(new_match,
                             cand_ids[jnp.where(new_match, res.point_idx, 0)]
                             .astype(jnp.int32),
                             assoc)
    matched = merged_assoc >= 0
    pw = arena.pt_pos[jnp.where(matched, merged_assoc, 0)]
    obs = optimizer.PoseObs(
        pw=jnp.where(matched[:, None], pw, 0.0),
        uv=frame.uv, ur=frame.ur,
        inv_sigma2=_inv_sigma2(frame.level, sf),
        valid=matched,
    )
    T_opt, inl, n_inl = optimizer.pose_optimization(T, obs, K, cam.bf)
    final_assoc = jnp.where(inl & matched, merged_assoc, -1)
    # visibility bookkeeping (MapPoint::IncreaseVisible/Found)
    vis_idx = jnp.where(vis, jnp.arange(arena.pmax), arena.pmax - 1)
    arena = arena._replace(
        pt_visible=arena.pt_visible.at[vis_idx].add(vis.astype(jnp.int32)))
    fnd = final_assoc >= 0
    arena = arena._replace(
        pt_found=arena.pt_found.at[
            jnp.where(fnd, final_assoc, arena.pmax - 1)].add(fnd.astype(jnp.int32)))
    return arena, T_opt, final_assoc, n_inl


@partial(jax.jit, static_argnums=(7,))
def track_step(arena: ma.MapArena, last: FrameState, velocity: jnp.ndarray,
               has_velocity, gray: jnp.ndarray, depth: jnp.ndarray,
               mask: jnp.ndarray, cfg: SlamConfig, ref_kf,
               temporal_points=False):
    """The fused per-frame program: extraction -> frame build -> motion-model
    tracking (with wide-radius retry) -> local-map tracking -> velocity and
    keyframe statistics. One device round-trip per frame; the host reads a
    handful of scalars to drive the state machine."""
    cam = cfg.camera
    feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
    frame = build_frame(feats, depth, mask, cam)
    return track_frame_core(arena, last, velocity, has_velocity, frame,
                            cfg, ref_kf, temporal_points)


@partial(jax.jit, static_argnums=(5,))
def track_frame_core(arena: ma.MapArena, last: FrameState,
                     velocity: jnp.ndarray, has_velocity, frame: Frame,
                     cfg: SlamConfig, ref_kf, temporal_points=False):
    """Frame-level tracking core (shared by RGB-D / stereo / monocular).

    temporal_points: anchor motion-model matching on last-frame depth
    backprojections too — localization-only mode (see track_motion_model).
    """
    cam = cfg.camera
    # world points of the last frame (map point if associated, else depth)
    lf = last.frame
    pc = cam_ops.backproject(lf.uv, lf.depth, cam)
    pw_depth = lie.se3_apply(lie.se3_inverse(last.T_cw), pc)
    has_pt = last.assoc >= 0
    pt_rows = jnp.where(has_pt, last.assoc, 0)
    pts_w = jnp.where(has_pt[:, None], arena.pt_pos[pt_rows], pw_depth)

    T_pred = jnp.where(has_velocity, velocity @ last.T_cw, last.T_cw)
    T1, assoc1, n1, _ = track_motion_model(last, pts_w, frame, T_pred, cfg,
                                           temporal_points=temporal_points)

    def wide_retry(_):
        return track_motion_model(last, pts_w, frame, last.T_cw, cfg,
                                  radius_px=30.0,
                                  temporal_points=temporal_points)

    T1, assoc1, n1, _ = jax.lax.cond(
        n1 < 10, wide_retry,
        lambda _: (T1, assoc1, n1, jnp.asarray(0, n1.dtype)), None)

    arena, T2, assoc2, n2 = track_local_map(arena, frame, T1, cfg, assoc1)

    # Re-project onto SE(3): the velocity cycle's transpose-inverse
    # amplifies any SO(3) deviation geometrically (see lie.so3_project).
    T2 = lie.se3_orthonormalize(T2)
    velocity_new = T2 @ lie.se3_inverse(last.T_cw)
    th_depth_m = cam.bf * cam.th_depth / cam.fx
    close = frame.valid & (frame.depth > 0) & (frame.depth < th_depth_m)
    close_tracked = jnp.sum(close & (assoc2 >= 0))
    close_untracked = jnp.sum(close & (assoc2 < 0))
    T_cr = T2 @ lie.se3_inverse(arena.kf_pose[ref_kf])
    stats = jnp.stack([n1, n2, close_tracked, close_untracked])
    return arena, FrameState(frame=frame, T_cw=T2, assoc=assoc2), \
        velocity_new, T_cr, stats


# ----------------------------------------------------------------------------
# Host state machine
# ----------------------------------------------------------------------------

class Tracking:
    """Host-side tracker mirroring the reference Tracking state machine.

    With `pipeline=True` the per-frame device program for frame t+1 is
    dispatched BEFORE frame t's scalar results are read back, hiding the
    host<->device round-trip latency.
    Keyframe decisions then lag by one frame — the analogue of the
    reference's asynchronous LocalMapping thread. Poses are exact in
    `camera_trajectory()`; the per-call return value is the best estimate at
    dispatch time.
    """

    def __init__(self, cfg: SlamConfig, kmax: int = 512, pmax: int = 65536,
                 pipeline: bool = False):
        self.cfg = cfg
        self.arena = ma.new_arena(kmax, pmax, cfg.orb.n_features)
        self.state = TrackState.NO_IMAGES_YET
        self.last: Optional[FrameState] = None
        self.velocity: Optional[jnp.ndarray] = None
        self.ref_kf: int = 0
        self.ref_kf_matches: int = 0
        self.frames_since_kf: int = 0
        self.frame_id: int = 0
        # per-frame trajectory records: (timestamp, ref_kf, T_cr, lost)
        self.records: list = []
        self.n_inliers: int = 0
        self.mapping_enabled: bool = True   # localization mode toggle
        self.use_local_ba: bool = True      # LocalMapping's BA stage
        self.loop_closer = None             # optional LoopCloser (needs vocab)
        self.pipeline = pipeline
        self.use_triangulation = True       # CreateNewMapPoints epipolar stage
        self.commit_every = 3               # frames per host sync (pipeline mode)
        self._pending = []                  # in-flight frames (pipeline mode)
        self._ref_m_dev = None              # deferred ref-match scalar (pipeline)
        self._loop_delta = None             # (pre, post) ref pose around a loop
        # Keyframe timestamps live host-side: float32 cannot represent TUM
        # epoch seconds (~1.3e9, ULP=128 s) so device kf_time would corrupt
        # KeyFrameTrajectory.txt timestamps (list index == arena kf slot).
        self.kf_timestamps: list[float] = []
        self.arena_full_warned = False
        self.kf_arena_full_warned = False
        self._compact_requested = False
        self.compact_min_gain = 8   # min slots a compaction must free
        # Sensor modality, set by the mono entry point: the keyframe cadence
        # rules differ (thRefRatio 0.9 vs 0.75, dense mono insertion) and
        # must NOT be inferred from per-frame depth statistics — an RGB-D
        # frame that momentarily sees only far geometry is not monocular.
        self.sensor_mono = False
        # Cached device scalars: jnp.asarray(bool/int) per frame is a small
        # host->device upload, several per frame on the hot path.
        self._jtrue = jnp.asarray(True)
        self._jfalse = jnp.asarray(False)
        self._eye4 = jnp.eye(4)

    def _jbool(self, b: bool) -> jnp.ndarray:
        return self._jtrue if b else self._jfalse

    @property
    def ref_kf(self) -> int:
        return self._ref_kf

    @ref_kf.setter
    def ref_kf(self, v: int):
        """Keeps a device-resident mirror: passing jnp.asarray(ref_kf) per
        frame is a small upload the hot path doesn't need to repeat."""
        self._ref_kf = int(v)
        self._ref_kf_dev = jnp.asarray(self._ref_kf)

    # -- helpers -------------------------------------------------------------
    @property
    def n_kf_host(self) -> int:
        """Keyframe count WITHOUT a device sync (kf_timestamps mirrors the
        arena's monotonic n_kf cursor): a bare int(arena.n_kf) waits for the
        device."""
        return len(self.kf_timestamps)

    def _do_keyframe(self, frame: Frame, T, assoc, timestamp: float):
        """The LocalMapping duties at keyframe insertion (LocalMapping::Run,
        LocalMapping.cc:47-112) in ONE device dispatch, then the host-side
        bookkeeping (ref keyframe, loop closing). Returns (assoc, T_refined);
        performs exactly one device sync (the ref-match count)."""
        cfg = self.cfg
        self._loop_delta = None
        new_n_kf = self.n_kf_host + 1
        use_ba = self.use_local_ba and new_n_kf >= 3
        self.arena, assoc, T_out, ref_m = keyframe_program(
            self.arena, frame, T, assoc, jnp.asarray(timestamp), cfg,
            self.use_triangulation, use_ba)
        self._note_keyframe(timestamp)
        self.ref_kf = new_n_kf - 1
        if self.pipeline:
            # Defer the scalar read: int(ref_m) here would stall the host
            # for the whole keyframe program plus a round trip.
            # The future joins the next flush()'s batched device_get;
            # ref_kf_matches stays stale for <= commit_every frames — the
            # same staleness the reference's asynchronous LocalMapping has.
            self._ref_m_dev = ref_m
        else:
            self.ref_kf_matches = int(ref_m)
        self.frames_since_kf = 0
        if self.loop_closer is not None:
            pre_pose = self.arena.kf_pose[self.ref_kf]
            n_loops = len(self.loop_closer.loops)
            self.arena = self.loop_closer.process_keyframe(
                self.arena, self.ref_kf)
            if len(self.loop_closer.loops) > n_loops:
                # A loop correction moved the map: re-anchor the live
                # tracker in the corrected frame (the reference's Tracking
                # continues from the corrected mpCurrentKeyFrame pose after
                # CorrectLoop; without this the motion model fights the
                # correction and drags the map back). pre->post is the
                # current keyframe's own correction; callers holding a
                # LATER in-flight pose re-anchor via _loop_delta, which
                # preserves their relative pose to this keyframe.
                post_pose = self.arena.kf_pose[self.ref_kf]
                self._loop_delta = (pre_pose, post_pose)
                T_out = post_pose
                # SearchAndFuse redirected/merged map points
                # (MapPoint::Replace) — the pre-correction assoc now points
                # at invalidated slots, which starves the next frame's
                # frame-to-frame matching (observed: 0 matches -> spurious
                # relocalization). The keyframe's fused obs row IS the
                # refreshed association.
                assoc = self.arena.kf_obs[self.ref_kf]
                # Drop the motion model: the frame-to-frame velocity was
                # estimated against the PRE-correction map, and tracking
                # near a drifted seam is exactly where that estimate goes
                # bad (observed: a 0.2 m velocity spike at the seam made
                # the next prediction miss the corrected map, frame-to-
                # frame matching returned 0, and relocalization adopted a
                # perceptually-aliased wrong pose the run never recovered
                # from). One frame of searching around the corrected
                # keyframe pose re-establishes it.
                self.velocity = None
        return assoc, T_out

    def _note_keyframe(self, timestamp: float):
        """Record a keyframe's timestamp host-side (slot == list index) and
        surface an arena-full warning once (silent slot exhaustion otherwise
        just stops point creation)."""
        self.kf_timestamps.append(float(timestamp))
        if not self.arena_full_warned and self.n_kf_host % 16 == 0 and \
                int(self.arena.n_pt) >= self.arena.pmax:
            import warnings
            warnings.warn(
                "gdslam_tpu: map-point arena is full (pmax="
                f"{self.arena.pmax}); new map points are no longer created. "
                "Construct Tracking with a larger pmax for long sequences.")
            self.arena_full_warned = True

    def _world_points_for_last(self) -> jnp.ndarray:
        """[N, 3] world position per last-frame keypoint: map point if
        associated, else backprojected depth (temporal VO points)."""
        lf = self.last.frame
        pc = cam_ops.backproject(lf.uv, lf.depth, self.cfg.camera)
        pw_depth = lie.se3_apply(lie.se3_inverse(self.last.T_cw), pc)
        has_pt = self.last.assoc >= 0
        pt_rows = jnp.where(has_pt, self.last.assoc, 0)
        return jnp.where(has_pt[:, None], self.arena.pt_pos[pt_rows], pw_depth)

    def reset(self):
        """Tracking::Reset (Tracking.cc:1834-1880): wipe the map, keyframe
        database, trajectory records, and state; the system re-initializes
        from the next frame. Triggered by System::Reset or automatically on
        early loss (Tracking.cc:618-626)."""
        self.arena = ma.new_arena(self.arena.kmax, self.arena.pmax,
                                  self.cfg.orb.n_features)
        self.state = TrackState.NO_IMAGES_YET
        self.last = None
        self.velocity = None
        self.ref_kf = 0
        self.ref_kf_matches = 0
        self.frames_since_kf = 0
        self.records = []
        self._pending = []
        self._ref_m_dev = None
        self.kf_timestamps = []
        self._mono_first = None
        self.arena_full_warned = False
        self.kf_arena_full_warned = False
        self._compact_requested = False
        if self.loop_closer is not None:
            self.loop_closer.reset()

    def _on_lost(self, timestamp: float, T_last):
        """LOST handling incl. the early-loss auto-reset: LOST with <=5
        keyframes wipes and restarts the whole system (Tracking.cc:618-626
        -> System::Reset)."""
        self.state = TrackState.LOST
        self._record(timestamp, T_last, lost=True)
        if self.mapping_enabled and self.n_kf_host <= 5:
            self.reset()

    def light_track(self, frame: Frame):
        """Map-preserving pose pre-pass (LightTrack, Tracking.cc:654-760 /
        LightTrackWithMotionModel, Tracking.cc:1127-1195): motion-model
        matching + pose GN against the last frame's points. NO tracker state
        is modified — the reference backs up and restores mLastFrame; here
        the device program is pure so nothing needs restoring. Refuses to
        run uninitialized (Tracking.cc:660-664). Returns (ok, T_cw)."""
        if self.state != TrackState.OK or self.last is None:
            return False, None
        pts_w = self._world_points_for_last()
        T_pred = (self.velocity @ self.last.T_cw
                  if self.velocity is not None else self.last.T_cw)
        T, _, n_inl, _ = track_motion_model(self.last, pts_w, frame,
                                            T_pred, self.cfg)
        if int(n_inl) < 10:
            T, _, n_inl, _ = track_motion_model(self.last, pts_w, frame,
                                                self.last.T_cw, self.cfg,
                                                radius_px=30.0)
        return int(n_inl) >= 10, T

    def process(self, gray: jnp.ndarray, depth: jnp.ndarray,
                mask: jnp.ndarray, timestamp: float) -> np.ndarray:
        """Track one RGB-D frame. Returns the 4x4 T_cw estimate."""
        cfg = self.cfg
        cam = cfg.camera
        gray = jnp.asarray(gray)
        depth = jnp.asarray(depth)
        mask = jnp.asarray(mask)

        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
            frame = build_frame(feats, depth, mask, cam)
            n_valid = int(jnp.sum(frame.valid))
            # Reference gate: >500 keypoints of a 1500 budget (Tracking.cc:
            # 767) — scaled to small test rigs as a quarter of the budget
            # (dynamic-object masking can legitimately cull a third of the
            # keypoints and RGB-D init only needs depth seeds).
            if n_valid >= min(cfg.tracking.min_init_features,
                              cfg.orb.n_features // 4):
                T0 = jnp.eye(4)
                self.arena, assoc = stereo_initialize(self.arena, frame, T0, cfg)
                self._note_keyframe(timestamp)
                self.last = FrameState(frame=frame, T_cw=T0, assoc=assoc)
                self.state = TrackState.OK
                self.ref_kf = 0
                # with a single keyframe every point has one observation
                self.ref_kf_matches = int(ref_tracked_points(self.arena, 0, 1))
                self.frames_since_kf = 0
                self._record(timestamp, T0, lost=False)
            else:
                self.state = TrackState.NOT_INITIALIZED
                self._record(timestamp, jnp.eye(4), lost=True)
            self.frame_id += 1
            return np.asarray(jnp.eye(4))

        if self.pipeline:
            return self._process_pipelined(gray, depth, mask, timestamp)

        # --- normal tracking: ONE fused device program + one scalar sync ---
        has_vel = self.velocity is not None
        vel = self.velocity if has_vel else jnp.eye(4)
        arena2, new_last, vel_new, T_cr, stats = track_step(
            self.arena, self.last, vel, jnp.asarray(has_vel), gray, depth,
            mask, cfg, jnp.asarray(self.ref_kf),
            jnp.asarray(not self.mapping_enabled))
        n1, n_inl, close_tracked, close_untracked = (
            int(x) for x in jax.device_get(stats))
        ok = n1 >= 10 and n_inl >= 30
        if ok:
            self.arena = arena2
            T, assoc, frame = new_last.T_cw, new_last.assoc, new_last.frame
        else:
            frame = new_last.frame
            ok, T, assoc, n_inl = self._relocalize(frame)
            if not ok:
                T_last = self.last.T_cw
                self._on_lost(timestamp, T_last)
                self.frame_id += 1
                return np.asarray(T_last)
            vel_new = None
            T_cr = T @ lie.se3_inverse(self.arena.kf_pose[self.ref_kf])

        self.n_inliers = n_inl
        self.velocity = vel_new
        self.last = FrameState(frame=frame, T_cw=T, assoc=assoc)
        self.state = TrackState.OK
        self.frames_since_kf += 1
        self.records.append((float(timestamp), self.ref_kf, T_cr, False))

        if self.mapping_enabled and self._need_keyframe_stats(
                n_inl, close_tracked, close_untracked):
            assoc, T = self._do_keyframe(frame, T, assoc, timestamp)
            self.last = FrameState(frame=frame, T_cw=T, assoc=assoc)
        self.frame_id += 1
        return np.asarray(T)

    # ------------------------------------------------------- other sensors
    def process_stereo(self, gray_left: jnp.ndarray, gray_right: jnp.ndarray,
                       mask, timestamp: float) -> np.ndarray:
        """Rectified stereo tracking (GrabImageStereo, Tracking.cc:156):
        extract both views, stereo-match for per-keypoint depth, then run
        the common frame pipeline."""
        from gdslam_tpu.frontend.frame import build_frame_stereo
        from gdslam_tpu.ops import stereo as stereo_ops
        cfg = self.cfg
        cam = cfg.camera
        if mask is None:
            mask = jnp.ones((cam.height, cam.width))
        fl = extractor.extract(jnp.asarray(gray_left), cfg.orb, cam.height,
                               cam.width)
        frx = extractor.extract(jnp.asarray(gray_right), cfg.orb, cam.height,
                                cam.width)
        ur, depth = stereo_ops.stereo_match(
            fl.uv, fl.level, fl.desc, fl.valid,
            frx.uv, frx.level, frx.desc, frx.valid,
            cam.bf, cam.bf / cam.fx,
            jnp.asarray(gray_left), jnp.asarray(gray_right),
            float(cfg.orb.scale_factor))
        frame = build_frame_stereo(fl, ur, depth, jnp.asarray(mask), cam)
        return self._process_built_frame(frame, timestamp)

    def process_mono(self, gray: jnp.ndarray, timestamp: float) -> np.ndarray:
        """Monocular tracking (GrabImageMonocular, Tracking.cc:371): two-view
        H/F bootstrap, then the common pipeline with mono-only observations;
        the map grows past the bootstrap pair via epipolar triangulation at
        keyframe insertion (mapping.create_new_map_points)."""
        from gdslam_tpu.frontend import initializer as ini
        self.sensor_mono = True
        cfg = self.cfg
        cam = cfg.camera
        gray = jnp.asarray(gray)
        feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
        mask1 = jnp.ones((cam.height, cam.width))
        frame = build_frame(feats, jnp.zeros((cam.height, cam.width)),
                            mask1, cam)
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            if getattr(self, "_mono_first", None) is None:
                self._mono_first = (frame, timestamp)
                self.state = TrackState.NOT_INITIALIZED
                self.frame_id += 1
                return np.eye(4)
            first, ts0 = self._mono_first
            from gdslam_tpu.ops import hamming, orb as orb_ops
            D = hamming.hamming_matrix(
                orb_ops.descriptors_pm1(first.desc, first.valid),
                orb_ops.descriptors_pm1(frame.desc, frame.valid))
            best, second, idx = hamming.best_two(D, axis=1)
            good = (best < 50) & (best.astype(jnp.float32)
                                  < 0.9 * second.astype(jnp.float32)) & first.valid
            res = ini.initialize(first.uv, frame.uv[idx], good,
                                 jax.random.PRNGKey(0), _K(cfg))
            if not bool(res.ok):
                self._mono_first = (frame, timestamp)
                self.frame_id += 1
                return np.eye(4)
            self._mono_bootstrap(first, ts0, frame, timestamp, idx, res)
            self.frame_id += 1
            return np.asarray(res.T_21)
        # normal tracking on the mono frame (ur=-1 everywhere)
        return self._process_built_frame(frame, timestamp)

    def _mono_bootstrap(self, first: Frame, ts0, frame: Frame, ts1, idx, res):
        """Insert the two bootstrap keyframes + triangulated points."""
        # Scale: normalize median scene depth to ~2m (mono scale is free;
        # the reference normalizes by median depth, Tracking.cc mono init).
        z = res.points[:, 2]
        # nanmedian, NOT median: median over a where(...nan) array is NaN
        # whenever ANY entry is masked, which silently skipped this
        # normalization entirely and left the mono map at the essential-
        # matrix gauge (|t|=1 -> ~70x metric scale; the Sim3 essential
        # graph's translation residuals then swamp its scale residuals).
        med = jnp.nanmedian(jnp.where(res.is_good, z, jnp.nan))
        med = jnp.where(jnp.isfinite(med), med, 1.0)
        scale = 2.0 / jnp.maximum(med, 1e-6)
        pts = res.points * scale
        T21 = res.T_21.at[:3, 3].multiply(scale)
        # pseudo-depth for the first frame's keypoints = triangulated z
        depth1 = jnp.where(res.is_good, pts[:, 2], 0.0)
        f1 = first._replace(depth=depth1, ur=-jnp.ones_like(first.ur))
        self.arena, assoc1 = stereo_initialize(
            self.arena, f1, jnp.eye(4), self.cfg)
        self._note_keyframe(ts0)
        # second keyframe observes the same points via the match index
        assoc2 = -jnp.ones_like(assoc1)
        matched = res.is_good & (assoc1 >= 0)
        assoc2 = assoc2.at[idx].set(jnp.where(matched, assoc1, -1))
        f2 = frame
        self.arena, assoc2 = insert_keyframe(
            self.arena, f2, T21, assoc2, jnp.asarray(ts1), self.cfg)
        self._note_keyframe(ts1)
        self.last = FrameState(frame=f2, T_cw=T21, assoc=assoc2)
        self.state = TrackState.OK
        self.ref_kf = 1
        self.ref_kf_matches = int(ref_tracked_points(self.arena, 1, 1))
        self.frames_since_kf = 0
        self.records.append((float(ts0), 0, jnp.eye(4), False))
        self.records.append((float(ts1), 1, jnp.eye(4), False))

    def _process_built_pipelined(self, frame: Frame, timestamp: float):
        """Pipelined dispatch for a pre-built Frame (the GD / geometry /
        stereo paths): identical to _process_pipelined but without the
        extraction stage (the caller already extracted). One batched scalar
        sync per commit_every frames instead of several per frame: each sync
        stalls the host until the device drains its queue."""
        cfg = self.cfg
        has_vel = self.velocity is not None
        vel = self.velocity if has_vel else self._eye4
        out = track_frame_core(
            self.arena, self.last, vel, self._jbool(has_vel), frame, cfg,
            self._ref_kf_dev, self._jbool(not self.mapping_enabled))
        return self.adopt_dispatched(out, timestamp)

    def adopt_dispatched(self, out, timestamp: float):
        """Adopt a just-dispatched track_frame_core output tuple (pipelined
        paths): tentative state adoption, async scalar readback, deferred
        commit. The caller must have dispatched against the CURRENT
        arena/last/velocity (the backup is taken here)."""
        arena2, new_last, vel_new, T_cr, stats = out
        prev_backup = (self.arena, self.last, self.velocity)
        self.arena = arena2
        self.last = new_last
        self.velocity = vel_new
        self._pending.append((stats, T_cr, new_last, timestamp, prev_backup))
        if len(self._pending) >= self.commit_every:
            self.flush()
        self.frame_id += 1
        if self.last is None:  # flush hit the early-loss auto-reset
            return jnp.eye(4)
        return self.last.T_cw

    def _process_built_frame(self, frame: Frame, timestamp: float) -> np.ndarray:
        """Common tracking body for a pre-built Frame (stereo/mono paths)."""
        cfg = self.cfg
        if self.state not in (TrackState.NO_IMAGES_YET,
                              TrackState.NOT_INITIALIZED) and self.pipeline:
            return self._process_built_pipelined(frame, timestamp)
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            n_valid = int(jnp.sum(frame.valid))
            min_init = min(cfg.tracking.min_init_features,
                           cfg.orb.n_features // 4)
            if n_valid >= min_init and int(jnp.sum(frame.depth > 0)) > 100:
                T0 = jnp.eye(4)
                self.arena, assoc = stereo_initialize(self.arena, frame, T0, cfg)
                self._note_keyframe(timestamp)
                self.last = FrameState(frame=frame, T_cw=T0, assoc=assoc)
                self.state = TrackState.OK
                self.ref_kf = 0
                self.ref_kf_matches = int(ref_tracked_points(self.arena, 0, 1))
                self.frames_since_kf = 0
                self._record(timestamp, T0, lost=False)
            else:
                self.state = TrackState.NOT_INITIALIZED
                self._record(timestamp, jnp.eye(4), lost=True)
            self.frame_id += 1
            return np.eye(4)
        has_vel = self.velocity is not None
        vel = self.velocity if has_vel else jnp.eye(4)
        arena2, new_last, vel_new, T_cr, stats = track_frame_core(
            self.arena, self.last, vel, jnp.asarray(has_vel), frame, cfg,
            jnp.asarray(self.ref_kf), jnp.asarray(not self.mapping_enabled))
        n1, n_inl, close_tracked, close_untracked = (
            int(x) for x in jax.device_get(stats))
        ok = n1 >= 10 and n_inl >= 30
        if not ok:
            ok, T, assoc, n_inl = self._relocalize(frame)
            if not ok:
                T_last = self.last.T_cw
                self._on_lost(timestamp, T_last)
                self.frame_id += 1
                return np.asarray(T_last)
            self.velocity = None
            self.last = FrameState(frame=frame, T_cw=T, assoc=assoc)
        else:
            self.arena = arena2
            self.last = new_last
            self.velocity = vel_new
        self.state = TrackState.OK
        self.n_inliers = n_inl
        self.frames_since_kf += 1
        self._record(timestamp, self.last.T_cw, lost=False)
        if self.mapping_enabled and self._need_keyframe_stats(
                n_inl, close_tracked, close_untracked):
            assoc, T = self._do_keyframe(self.last.frame, self.last.T_cw,
                                         self.last.assoc, timestamp)
            self.last = self.last._replace(assoc=assoc, T_cw=T)
        self.frame_id += 1
        return np.asarray(self.last.T_cw)

    # ---------------------------------------------------------- pipelining
    def _process_pipelined(self, gray, depth, mask, timestamp) -> np.ndarray:
        """Dispatch the current frame, then commit the previous one while
        the device works — the host never stalls on the current frame."""
        cfg = self.cfg
        has_vel = self.velocity is not None
        vel = self.velocity if has_vel else self._eye4
        out = track_step(self.arena, self.last, vel, self._jbool(has_vel),
                         gray, depth, mask, cfg, self._ref_kf_dev,
                         self._jbool(not self.mapping_enabled))
        # Tentative adoption (no sync — these are device futures); each
        # pending entry carries ITS OWN pre-dispatch backup so a lagged
        # failure rolls back to the state before the failed frame, not
        # before the most recent dispatch. The returned pose is the
        # in-flight device array: converting would cost a round trip per
        # frame, exactly what pipelining hides. Exact poses
        # come from camera_trajectory() after flush().
        return self.adopt_dispatched(out, timestamp)

    def _commit(self, pending, stats_host=None):
        """Run the state machine on a lagged frame's (read) scalars."""
        stats, T_cr, committed_last, ts, backup = pending
        if stats_host is None:
            stats_host = jax.device_get(stats)
        n1, n_inl, close_tracked, close_untracked = (
            int(x) for x in stats_host)
        cfg = self.cfg
        if not (n1 >= 10 and n_inl >= 30):
            # the failed frame (and any in-flight successors) consumed a bad
            # state: roll back to the state before THIS frame's dispatch
            self.arena, self.last, self.velocity = backup
            ok, T, assoc, n_inl2 = self._relocalize(committed_last.frame)
            if ok:
                self.last = FrameState(frame=committed_last.frame, T_cw=T,
                                       assoc=assoc)
                self.velocity = None
                self.state = TrackState.OK
                self.records.append((float(ts), self.ref_kf,
                                     T @ lie.se3_inverse(
                                         self.arena.kf_pose[self.ref_kf]),
                                     False))
            else:
                self.state = TrackState.LOST
                self.records.append((float(ts), self.ref_kf,
                                     self.last.T_cw @ lie.se3_inverse(
                                         self.arena.kf_pose[self.ref_kf]),
                                     True))
                if self.mapping_enabled and self.n_kf_host <= 5:
                    self.reset()
            return False
        self.n_inliers = n_inl
        self.state = TrackState.OK
        self.frames_since_kf += 1
        self.records.append((float(ts), self.ref_kf, T_cr, False))
        if self.mapping_enabled and self._need_keyframe_stats(
                n_inl, close_tracked, close_untracked):
            frame = committed_last.frame
            T = committed_last.T_cw
            assoc, _ = self._do_keyframe(frame, T, committed_last.assoc, ts)
            if self._loop_delta is not None:
                # a loop correction moved the map while later frames were
                # in flight: re-anchor the live pose, preserving its
                # relative transform to the corrected keyframe
                pre, post = self._loop_delta
                self._loop_delta = None
                if self.last is not None:
                    self.last = self.last._replace(
                        T_cw=self.last.T_cw @ lie.se3_inverse(pre) @ post)
            if self.n_kf_host % 8 == 0:
                from gdslam_tpu.backend import gba
                self.arena = gba.keyframe_culling(self.arena)
        return True

    def flush(self):
        """Commit all in-flight frames (call before reading trajectories)."""
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        # ONE round trip for the whole batch, including any deferred
        # keyframe ref-match scalar from _do_keyframe.
        to_get = [p[0] for p in batch]
        if self._ref_m_dev is not None:
            to_get.append(self._ref_m_dev)
        got = jax.device_get(to_get)
        if self._ref_m_dev is not None:
            self.ref_kf_matches = int(got[-1])
            self._ref_m_dev = None
            all_stats = got[:-1]
        else:
            all_stats = got
        for k, (pend, st) in enumerate(zip(batch, all_stats)):
            if not self._commit(pend, stats_host=st):
                # later in-flight frames consumed the bad state: drop them,
                # but keep their timestamps in the trajectory as lost records
                # so every input frame appears in CameraTrajectory.txt.
                # _commit's early-loss auto-reset can wipe the tracker
                # (self.last=None) mid-flush — record identity T_cr then.
                if self.last is not None:
                    T_cr_drop = self.last.T_cw @ lie.se3_inverse(
                        self.arena.kf_pose[self.ref_kf])
                else:
                    T_cr_drop = jnp.eye(4)
                for dropped in batch[k + 1:]:
                    self.records.append(
                        (float(dropped[3]), self.ref_kf, T_cr_drop, True))
                break
        if self._compact_requested and not self._pending:
            self._maybe_compact()

    def _maybe_compact(self):
        """Recycle culled keyframe slots once the arena saturates (the
        counterpart of the reference freeing bad keyframes,
        KeyFrame::SetBadFlag KeyFrame.cc:533-580). Runs only at
        pipeline-quiescent points (no in-flight frames): the permutation
        invalidates slot indices held by pending rollback backups.

        Culls redundant keyframes first, then compacts survivors to the
        front (recency == slot order preserved) and remaps every host-side
        slot reference: timestamps, trajectory records, ref_kf, and the
        loop closer's BoW database."""
        if not self._compact_requested:
            return
        self._compact_requested = False
        assert not self._pending, "compaction requires a quiescent pipeline"
        from gdslam_tpu.backend import gba
        self.arena = gba.keyframe_culling(self.arena)
        valid = np.asarray(self.arena.kf_valid)   # one sync; rare event
        n_kf = self.n_kf_host
        keep = np.nonzero(valid[:n_kf])[0]
        if len(keep) > n_kf - max(1, self.compact_min_gain):
            # culling freed almost nothing: warn once, mapping stops growing
            if not self.kf_arena_full_warned:
                import warnings
                warnings.warn(
                    "gdslam_tpu: keyframe arena is full (kmax="
                    f"{self.arena.kmax}) and culling frees too few slots; "
                    "no new keyframes will be created. Construct Tracking "
                    "with a larger kmax for long sequences.")
                self.kf_arena_full_warned = True
            return
        K = self.arena.kmax
        perm = np.concatenate(
            [keep, np.setdiff1d(np.arange(K), keep)]).astype(np.int32)
        new_of_old = np.zeros(K, np.int32)
        new_of_old[perm] = np.arange(K, dtype=np.int32)
        last_kept = 0
        for old in range(n_kf):
            if valid[old]:
                last_kept = new_of_old[old]
            else:
                new_of_old[old] = last_kept
        self.arena = ma.compact_keyframes(
            self.arena, jnp.asarray(perm), jnp.asarray(new_of_old),
            jnp.asarray(len(keep), jnp.int32))
        self.kf_timestamps = [self.kf_timestamps[i] for i in keep]
        self.records = [(ts, int(new_of_old[ref]), T_cr, lost)
                        for ts, ref, T_cr, lost in self.records]
        self.ref_kf = int(new_of_old[self.ref_kf])
        lc = self.loop_closer
        if lc is not None:
            from gdslam_tpu.backend import keyframe_db as kdb
            live = jnp.arange(K) < len(keep)
            pj = jnp.asarray(perm)
            lc.db = kdb.BowDatabase(
                vectors=jnp.where(live[:, None], lc.db.vectors[pj], 0.0),
                words=jnp.where(live[:, None], lc.db.words[pj], -1),
                valid=live & lc.db.valid[pj])
            if lc.last_loop_kf >= 0:
                lc.last_loop_kf = int(new_of_old[lc.last_loop_kf])
            lc._consistent = {}   # streak anchors refer to old slots
            lc.loops = [(int(new_of_old[a]), int(new_of_old[b]), T)
                        for a, b, T in lc.loops]

    def _relocalize(self, frame: Frame):
        """Relocalization (Tracking.cc:1670-1832): candidate keyframes from
        the BoW database (or, without a vocabulary, the most recent keyframes
        — short-term loss recovery), descriptor matching, vmapped EPnP-style
        2D-3D RANSAC (PnPsolver semantics, RANSAC(0.99,10,300) at
        Tracking.cc:1715 — works for depthless/mono keypoints), then pose
        optimization with a >=50-inlier acceptance. When the frame has dense
        depth, a 3D-3D rigid RANSAC result is used as a fallback hypothesis."""
        from gdslam_tpu.backend import solvers
        cfg = self.cfg
        cam = cfg.camera
        arena = self.arena
        n_kf = self.n_kf_host
        if n_kf == 0:
            return False, None, None, 0

        words = None
        candidates: list[int] = []
        if self.loop_closer is not None:
            from gdslam_tpu.backend import keyframe_db as kdb
            from gdslam_tpu.backend import vocabulary as voc
            lc = self.loop_closer
            words = voc.transform(frame.desc, lc.vocab.centers, lc.vocab.k,
                                  lc.vocab.levels)
            words = jnp.where(frame.valid, words, -1)
            vec = voc.bow_vector(words, words >= 0, lc.vocab.n_leaves)
            ids, scores, ok_c = kdb.reloc_candidates(lc.db, arena, vec)
            candidates = [int(ids[i]) for i in range(ids.shape[0])
                          if bool(ok_c[i]) and float(scores[i]) > 0]
        if not candidates:
            # No vocabulary (default System construction) or no BoW hits:
            # try the most recent keyframes — covers the common case of
            # short-term tracking loss near the last mapped region.
            candidates = list(range(n_kf - 1, max(-1, n_kf - 6), -1))

        # Match ALL candidates first (async device dispatches), then read
        # every match count in ONE batched device_get instead of one
        # round trip per candidate.
        matches = []
        for kf in candidates:
            if self.loop_closer is not None and words is not None:
                from gdslam_tpu.backend.loop_closing import _bow_guided_matches
                m_idx, n_m = _bow_guided_matches(
                    frame.desc, frame.valid, words,
                    arena.kf_desc[kf], arena.kf_kp_valid[kf],
                    self.loop_closer.db.words[kf])
            else:
                m_idx, n_m = _dense_ratio_matches(
                    frame.desc, frame.valid,
                    arena.kf_desc[kf], arena.kf_kp_valid[kf])
            matches.append((kf, m_idx, n_m))
        n_ms = jax.device_get([m[2] for m in matches])
        # Try candidates best-first (the reference iterates all candidates'
        # PnP solvers round-robin, Tracking.cc:1737; best-first reaches the
        # same accept with fewer RANSAC dispatches).
        order = sorted(range(len(matches)), key=lambda i: -int(n_ms[i]))
        for ci in order:
            kf, m_idx, _ = matches[ci]
            if int(n_ms[ci]) < 15:
                continue
            rows = jnp.maximum(m_idx, 0)
            pt = arena.kf_obs[kf][rows]
            has_pt = (m_idx >= 0) & (pt >= 0) & \
                arena.pt_valid[jnp.maximum(pt, 0)]
            pw = arena.pt_pos[jnp.maximum(pt, 0)]
            # 2D-3D PnP RANSAC: no keypoint depth required.
            res = solvers.ransac_pnp(
                pw, frame.uv, has_pt, _K(cfg), n_iters=300, min_inliers=10,
                px_threshold=5.991 ** 0.5,
                key=jax.random.PRNGKey(self.frame_id))
            if not bool(res.ok):
                # fallback hypothesis from 3D-3D where depth exists
                has_3d = has_pt & (frame.depth > 0)
                if int(jnp.sum(has_3d)) < 10:
                    continue
                q = cam_ops.backproject(frame.uv, frame.depth, cam)
                res = solvers.ransac_rigid(
                    pw, q, has_3d, jax.random.PRNGKey(self.frame_id),
                    _K(cfg), frame.uv, n_iters=300, min_inliers=10,
                    px_threshold=5.991 ** 0.5 * 2)
                if not bool(res.ok):
                    continue
            matched = has_pt & res.inliers
            obs = optimizer.PoseObs(
                pw=jnp.where(matched[:, None], pw, 0.0),
                uv=frame.uv, ur=frame.ur,
                inv_sigma2=_inv_sigma2(frame.level, float(cfg.orb.scale_factor)),
                valid=matched)
            T, inl, n_inl = optimizer.pose_optimization(
                res.T, obs, _K(cfg), cam.bf)
            if int(n_inl) < 10:
                continue
            # Grow the match set by projecting the whole map with the coarse
            # pose (SearchByProjection growth stage, Tracking.cc:1784-1818):
            # the candidate's own BoW matches rarely reach the 50-inlier
            # acceptance bar on their own.
            assoc0 = jnp.where(inl & matched, pt, -1)
            # Adopt the returned arena (pt_visible/pt_found bookkeeping) only
            # on acceptance: repeated failed relocalizations would otherwise
            # inflate pt_visible at wrong poses and push good points below
            # the 0.25 found/visible culling ratio.
            arena2, T2, assoc2, n2 = track_local_map(
                self.arena, frame, T, cfg, assoc0)
            if int(n2) >= 50:
                self.arena = arena2
                return True, T2, assoc2, int(n2)
        return False, None, None, 0

    def _need_keyframe_stats(self, n_inl: int, close_tracked: int,
                             close_untracked: int) -> bool:
        """NeedNewKeyFrame rules for RGB-D (Tracking.cc:1306-1390), fed by
        the statistics the fused track_step already computed."""
        if self.n_kf_host >= self.arena.kmax - 1:
            # Saturated: request a compaction pass (recycles culled slots —
            # KeyFrame::SetBadFlag frees them in the reference) at the next
            # pipeline-quiescent point; until then, no new keyframes.
            self._compact_requested = True
            if not self.pipeline:
                self._maybe_compact()
                return False
            return False
        # under heavy dynamic masking close_tracked can sit below 100
        # permanently; without the reference's busy-LocalMapping backpressure
        # (c1b) this would insert a keyframe EVERY frame, so enforce a small
        # minimum gap unless tracking is nearly lost
        need_close = close_tracked < 100 and close_untracked > 70 and \
            (self.frames_since_kf >= 3 or n_inl < 40)
        c1a = self.frames_since_kf >= self.cfg.camera.fps   # mMaxFrames
        # thRefRatio: 0.75 for RGB-D/stereo, 0.9 for monocular (Tracking.cc:
        # 1369-1374). The modality comes from the sensor configuration (set
        # by the mono entry point), NOT per-frame depth statistics: an RGB-D
        # frame that momentarily sees only far geometry is not monocular.
        mono = self.sensor_mono
        ratio = 0.9 if mono else 0.75
        # Mono c1b analogue (Tracking.cc:1355 mMinFrames=0 + idle mapper):
        # the reference inserts mono keyframes densely and culls redundant
        # ones later; a fixed fps/3 cadence replaces the busy-flag.
        if mono and self.frames_since_kf >= max(3, int(self.cfg.camera.fps) // 3) \
                and n_inl > 15:
            return True
        c2 = (n_inl < ratio * max(self.ref_kf_matches, 1) or need_close) \
            and n_inl > 15
        return c2 or (c1a and n_inl > 15)

    def _record(self, timestamp, T_cw, lost: bool):
        T_ref = self.arena.kf_pose[self.ref_kf]
        T_cr = T_cw @ lie.se3_inverse(T_ref)
        self.records.append((float(timestamp), self.ref_kf, T_cr, lost))

    # -- trajectory export ---------------------------------------------------
    def camera_trajectory(self) -> list[tuple[float, np.ndarray]]:
        """(timestamp, T_wc) per frame, recomputed through reference
        keyframes (System::SaveTrajectoryTUM, System.cc:418-476)."""
        out = []
        kf_pose = np.asarray(self.arena.kf_pose)
        for ts, ref, T_cr, lost in self.records:
            if lost:
                continue
            T_cw = np.asarray(T_cr) @ kf_pose[ref]
            out.append((ts, np.linalg.inv(T_cw)))
        return out

    def keyframe_trajectory(self) -> list[tuple[float, np.ndarray]]:
        n = int(self.arena.n_kf)
        poses = np.asarray(self.arena.kf_pose[:n])
        valid = np.asarray(self.arena.kf_valid[:n])
        # Timestamps come from the host-side list: device kf_time is float32,
        # which cannot represent TUM epoch seconds (ULP = 128 s at 1.3e9).
        times = np.asarray(self.arena.kf_time[:n], np.float64)
        for i in range(min(n, len(self.kf_timestamps))):
            times[i] = self.kf_timestamps[i]
        return [(float(times[i]), np.asarray(lie.se3_inverse(jnp.asarray(poses[i]))))
                for i in range(n) if valid[i]]
