"""Loop detection, Sim3/SE3 computation, and loop correction.

Re-design of the reference LoopClosing thread (LoopClosing.cc): detect
candidates via BoW (DetectLoop :103-230), geometrically validate with a
RANSAC similarity solver + guided matching (ComputeSim3 :231-400), then
correct: propagate the loop transform to the covisible group, fuse, and run
essential-graph optimization (+ global BA) (CorrectLoop :402-585, 645-750).

Host-side state machine (candidate consistency, accept/reject) around jitted
device programs (BoW scoring, dense Hamming matching, RANSAC battery, pose
graph). Runs synchronously at keyframe rate instead of on a thread — the
work itself is a handful of fused device programs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gdslam_tpu.backend import keyframe_db as kdb
from gdslam_tpu.backend import map_arena as ma
from gdslam_tpu.backend import pose_graph, solvers
from gdslam_tpu.backend import vocabulary as voc
from gdslam_tpu.config import SlamConfig
from gdslam_tpu.core import camera as cam_ops
from gdslam_tpu.core import lie
from gdslam_tpu.ops import hamming, orb as orb_ops

MIN_KF_GAP = 10          # >=10 KFs since last loop (LoopClosing.cc:110)
CONSISTENCY_TH = 3       # consecutive consistent detections (cc:43)
MIN_BOW_MATCHES = 20     # ComputeSim3 entry gate (cc:262)
MIN_ACCEPT_MATCHES = 40  # final acceptance (cc:395)


@jax.jit
def _bow_guided_matches(desc_a, valid_a, words_a, desc_b, valid_b, words_b):
    """SearchByBoW-style matching (ORBmatcher.cc:522): descriptors restricted
    to the same vocabulary word, ratio test 0.75. Dense: the word-equality
    mask replaces the feature-vector node walk."""
    pa = orb_ops.descriptors_pm1(desc_a, valid_a)
    pb = orb_ops.descriptors_pm1(desc_b, valid_b)
    D = hamming.hamming_matrix(pa, pb)
    same_word = (words_a[:, None] == words_b[None, :]) & \
        (words_a[:, None] >= 0)
    cost = jnp.where(same_word & valid_a[:, None] & valid_b[None, :],
                     D, 1 << 20)
    best, second, idx = hamming.best_two(cost, axis=1)
    good = (best < 50) & (best.astype(jnp.float32)
                          < 0.75 * jnp.minimum(second, 1 << 20).astype(jnp.float32))
    return jnp.where(good, idx, -1), jnp.sum(good)


def _inv_sigma2(level, scale: float):
    return 1.0 / (scale ** (2.0 * level.astype(jnp.float32)))


def _kf_points_cam(arena: ma.MapArena, kf, cfg: SlamConfig):
    """Per-keypoint 3D in the keyframe's camera: the observed map point
    transformed by the KF pose where one exists (the reference's
    vpMapPoints, ORBmatcher.cc:1110-1130), else the depth backprojection.
    Returns (X [N,3], has3d [N])."""
    obs = arena.kf_obs[kf]
    has_pt = (obs >= 0) & arena.pt_valid[jnp.maximum(obs, 0)]
    pw = arena.pt_pos[jnp.maximum(obs, 0)]
    X_map = lie.se3_apply(arena.kf_pose[kf], pw)
    z = arena.kf_depth[kf]
    X_depth = cam_ops.backproject(arena.kf_uv[kf], z, cfg.camera)
    X = jnp.where(has_pt[:, None], X_map, X_depth)
    has3d = arena.kf_kp_valid[kf] & (has_pt | (z > 0))
    return X, has3d


@partial(jax.jit, static_argnums=(6, 7))
def _sim3_verify_program(arena: ma.MapArena, kf_id, cand, S12, bow_idx,
                         loop_pt_mask, cfg: SlamConfig,
                         with_scale: bool = False):
    """The full ComputeSim3 verification tail as ONE device program:
    SearchBySim3-style mutual match growth through the candidate transform
    (ORBmatcher.cc:1102-1219), OptimizeSim3 GN refinement with Huber + chi2
    inlier erasure (Optimizer.cc:1262-1391), then the loop-map-point
    projection count that the final >=40 acceptance is taken over
    (LoopClosing.cc:355-400 SearchByProjection + nTotalMatches).

    S12 = (R, t, s) hypothesis mapping candidate-camera coords into
    current-camera coords. bow_idx: per-current-keypoint candidate keypoint
    index from BoW matching (-1 = none). loop_pt_mask: [pmax] bool, map
    points of the candidate's covisible group (mvpLoopMapPoints).

    Returns (R, t, s, n_opt_inliers, n_total_matches)."""
    from gdslam_tpu.frontend import matcher
    cam = cfg.camera
    sf = float(cfg.orb.scale_factor)
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    R12, t12, s12 = S12
    X1, has1 = _kf_points_cam(arena, kf_id, cfg)
    X2, has2 = _kf_points_cam(arena, cand, cfg)
    uv1, uv2 = arena.kf_uv[kf_id], arena.kf_uv[cand]
    lvl1, lvl2 = arena.kf_level[kf_id], arena.kf_level[cand]
    d1 = orb_ops.descriptors_pm1(arena.kf_desc[kf_id],
                                 arena.kf_kp_valid[kf_id])
    d2 = orb_ops.descriptors_pm1(arena.kf_desc[cand],
                                 arena.kf_kp_valid[cand])

    def project(Xc):
        z = jnp.maximum(Xc[..., 2], 1e-6)
        return jnp.stack([cam.fx * Xc[..., 0] / z + cam.cx,
                          cam.fy * Xc[..., 1] / z + cam.cy], axis=-1), \
            Xc[..., 2] > 0

    # --- SearchBySim3 growth, both directions, mutual agreement ----------
    radius2 = 7.5 * sf ** lvl2.astype(jnp.float32)
    X2_in1, zok2 = project(lie.sim3_apply(R12, t12, s12, X2))
    in1 = zok2 & (X2_in1[..., 0] >= 0) & (X2_in1[..., 0] < cam.width) & \
        (X2_in1[..., 1] >= 0) & (X2_in1[..., 1] < cam.height)
    mA = matcher.match_candidates(
        X2_in1, has2 & in1, d2, lvl2, jnp.zeros_like(radius2), radius2,
        uv1, has1, d1, lvl1, arena.kf_angle[kf_id],
        th_hamming=matcher.TH_HIGH, level_slack=1, use_rotation=False)
    R21, t21, s21 = lie.sim3_inverse(R12, t12, s12)
    radius1 = 7.5 * sf ** lvl1.astype(jnp.float32)
    X1_in2, zok1 = project(lie.sim3_apply(R21, t21, s21, X1))
    in2 = zok1 & (X1_in2[..., 0] >= 0) & (X1_in2[..., 0] < cam.width) & \
        (X1_in2[..., 1] >= 0) & (X1_in2[..., 1] < cam.height)
    mB = matcher.match_candidates(
        X1_in2, has1 & in2, d1, lvl1, jnp.zeros_like(radius1), radius1,
        uv2, has2, d2, lvl2, arena.kf_angle[cand],
        th_hamming=matcher.TH_HIGH, level_slack=1, use_rotation=False)
    # mA.point_idx[i1] = j2 ; mB.point_idx[j2] = i1 ; mutual check (cc:1207)
    j_of_i = mA.point_idx
    i_back = mB.point_idx[jnp.maximum(j_of_i, 0)]
    mutual = (j_of_i >= 0) & (i_back == jnp.arange(j_of_i.shape[0]))
    # union with BoW matches; BoW wins where both exist (the growth stage
    # only ADDS matches in the reference, cc:1150 "if(vpMatches12[i1])
    # continue")
    idx2 = jnp.where(bow_idx >= 0, bow_idx,
                     jnp.where(mutual, j_of_i, -1))
    valid = (idx2 >= 0) & has1 & has2[jnp.maximum(idx2, 0)]

    # --- OptimizeSim3 ----------------------------------------------------
    rows2 = jnp.maximum(idx2, 0)
    Rn, tn, sn, inl, n_opt = solvers.optimize_sim3(
        X1, X2[rows2], uv1, uv2[rows2],
        _inv_sigma2(lvl1, sf), _inv_sigma2(lvl2[rows2], sf), valid,
        (R12, t12, s12), K, with_scale)
    if with_scale:
        # Scale is WEAKLY observable in image space (projection is near
        # scale-invariant for distant structure: proj(sRX+t) ~ proj(RX)
        # when |RX| >> |t|), so the reprojection GN can drift the scale
        # while keeping residuals small (measured: 1.17 -> 0.96 against a
        # 1.3 ground truth). The 3D-3D Horn alignment over the GN's
        # inlier pairs constrains scale STRONGLY (spread ratio of the two
        # point sets); keep GN for match selection, Horn for the final
        # transform.
        Rh, th, sh = solvers.horn_alignment(
            X2[rows2], X1, (inl & valid).astype(jnp.float32),
            with_scale=True)
        Rn, tn, sn = Rh, th, sh

    # --- loop-map-point projection count (the >=40 acceptance basis) ----
    # Corrected current pose as a Sim3: Scw = S12 o T_cand_w
    # (LoopClosing.cc:341 mScw = gScm * gSmw).
    Tc = arena.kf_pose[cand]
    Rcw, tcw, scw = lie.sim3_compose(Rn, tn, sn, Tc[:3, :3], Tc[:3, 3], 1.0)
    cap = min(4096, arena.pmax)
    score = jnp.where(loop_pt_mask & arena.pt_valid,
                      1.0 + arena.pt_n_obs.astype(jnp.float32), 0.0)
    _, cand_ids = jax.lax.top_k(score, cap)
    cand_ids = cand_ids.astype(jnp.int32)
    pw = arena.pt_pos[cand_ids]
    uv_p, zok = project(lie.sim3_apply(Rcw, tcw, scw, pw))
    pvalid = loop_pt_mask[cand_ids] & arena.pt_valid[cand_ids] & zok & \
        (uv_p[..., 0] >= 0) & (uv_p[..., 0] < cam.width) & \
        (uv_p[..., 1] >= 0) & (uv_p[..., 1] < cam.height)
    pdesc = orb_ops.descriptors_pm1(arena.pt_desc[cand_ids], pvalid)
    mP = matcher.match_candidates(
        uv_p, pvalid, pdesc, jnp.zeros(cap, jnp.int32), jnp.zeros(cap),
        jnp.full(cap, 10.0), uv1, arena.kf_kp_valid[kf_id], d1, lvl1,
        arena.kf_angle[kf_id], th_hamming=matcher.TH_LOW, level_slack=8,
        use_rotation=False)
    proj_hit = mP.point_idx >= 0
    # nTotalMatches: keypoints matched by projection OR already Sim3 inliers
    n_total = jnp.sum(proj_hit | (inl & valid))
    return Rn, tn, sn, n_opt, n_total


class LoopCloser:
    def __init__(self, cfg: SlamConfig, vocab: voc.Vocabulary, kmax: int):
        self.cfg = cfg
        self.vocab = vocab
        self.db = kdb.new_db(kmax, cfg.orb.n_features, vocab.n_leaves)
        self.last_loop_kf = -MIN_KF_GAP
        self._consistent: dict[int, int] = {}   # candidate group -> streak
        self.loops: list[tuple[int, int, np.ndarray]] = []  # (cur, cand, T_meas)
        # bFixScale (Sim3Solver.h:20): True for RGB-D/stereo (metric depth),
        # False for monocular — System sets this from the sensor.
        self.fix_scale = True
        self.last_sim3 = None   # (R, t, s) of the last accepted loop

    def reset(self):
        """Clear the keyframe database + consistency state (the LoopClosing
        side of System::Reset -> KeyFrameDatabase::clear)."""
        self.db = kdb.new_db(self.db.words.shape[0],
                             self.cfg.orb.n_features, self.vocab.n_leaves)
        self.last_loop_kf = -MIN_KF_GAP
        self._consistent = {}
        self.loops = []

    # ------------------------------------------------------------------ add
    def add_keyframe(self, arena: ma.MapArena, kf_id: int):
        words = voc.transform(arena.kf_desc[kf_id], self.vocab.centers,
                              self.vocab.k, self.vocab.levels)
        words = jnp.where(arena.kf_kp_valid[kf_id], words, -1)
        vec = voc.bow_vector(words, words >= 0, self.vocab.n_leaves)
        self.db = kdb.db_add(self.db, jnp.asarray(kf_id), vec, words)

    # --------------------------------------------------------------- detect
    def detect(self, arena: ma.MapArena, kf_id: int) -> list[int]:
        """DetectLoop host logic with consistency streaks. Returns ALL
        candidates whose streak reached CONSISTENCY_TH (the reference's
        mvpEnoughConsistentCandidates, LoopClosing.cc:150-230 — ComputeSim3
        then tries each in turn)."""
        if kf_id - self.last_loop_kf < MIN_KF_GAP:
            return []
        # ONE batched device_get for ids/scores/min_score instead of three
        # separate np.asarray syncs.
        ids, scores, min_score = jax.device_get(
            kdb.loop_candidates(self.db, arena, jnp.asarray(kf_id)))
        cand = []
        for i, s in zip(ids, scores):
            if s > max(float(min_score), 1e-6) and i >= 0 and \
                    int(i) not in cand:
                cand.append(int(i))
        # Consistency groups: a candidate (or its covisible neighborhood)
        # must recur for CONSISTENCY_TH consecutive keyframes (cc:150-230).
        # Only the [n_cand, n_prev] covisibility entries the streak check
        # reads come to host, not the full [K,K] matrix (~1 MB per
        # keyframe).
        new_streaks: dict[int, int] = {}
        accepted: list[int] = []
        prev_ids = list(self._consistent.keys())
        if cand and prev_ids:
            covis_sub = jax.device_get(
                arena.covis[jnp.asarray(cand)][:, jnp.asarray(prev_ids)])
        for ci, c in enumerate(cand):
            streak = 1
            for pi, (prev, s) in enumerate(self._consistent.items()):
                # group consistency via the covisibility GRAPH (weight>=15
                # edges, matching GetConnectedKeyFrames semantics)
                if prev == c or covis_sub[ci, pi] >= 15:
                    streak = max(streak, s + 1)
            new_streaks[c] = streak
            if streak >= CONSISTENCY_TH:
                accepted.append(c)
        self._consistent = new_streaks
        return accepted

    # --------------------------------------------------------------- verify
    def compute_transform(self, arena: ma.MapArena, kf_id: int, cand: int):
        """ComputeSim3 (LoopClosing.cc:231-400): BoW matches -> Sim3 RANSAC
        hypothesis -> SearchBySim3 match growth -> OptimizeSim3 GN (>=20
        refined inliers, cc:371) -> loop-map-point projection with the
        final >=40-match acceptance (cc:395).

        Returns (ok, T_cur_cand [4,4], n_matches): T maps candidate-frame
        coords into current-frame coords (for mono, scale is folded into
        the rotation/translation part of the returned matrix; the raw
        (R, t, s) of the accepted transform is stored in self.last_sim3)."""
        cfg = self.cfg
        cam = cfg.camera
        m_idx, n_m = _bow_guided_matches(
            arena.kf_desc[kf_id], arena.kf_kp_valid[kf_id], self.db.words[kf_id],
            arena.kf_desc[cand], arena.kf_kp_valid[cand], self.db.words[cand])
        if int(n_m) < MIN_BOW_MATCHES:
            return False, None, 0
        # 3D per matched keypoint in each camera: the observed MAP POINT
        # where one exists, else the depth backprojection (Sim3Solver.cc:
        # 40-60 uses vpMapPoints — required for monocular, where kf_depth
        # is empty, and more drift-consistent for RGB-D too).
        rows = jnp.maximum(m_idx, 0)
        Q_cur, has_a = _kf_points_cam(arena, jnp.asarray(kf_id), cfg)
        P_all, has_b = _kf_points_cam(arena, jnp.asarray(cand), cfg)
        P_cand = P_all[rows]
        ok = (m_idx >= 0) & has_a & has_b[rows]
        with_scale = not self.fix_scale
        R, t, s, inl, n_inl, okflag = solvers.ransac_sim3(
            P_cand, Q_cur, ok, jax.random.PRNGKey(kf_id),
            n_iters=300, min_inliers=MIN_BOW_MATCHES, err_threshold=0.10,
            with_scale=with_scale,
            uv_p=arena.kf_uv[cand][rows], uv_q=arena.kf_uv[kf_id],
            K=(cam.fx, cam.fy, cam.cx, cam.cy),
            px_threshold=3.04 * float(cfg.orb.scale_factor) ** jnp.maximum(
                arena.kf_level[kf_id],
                arena.kf_level[cand][rows]).astype(jnp.float32))
        if not bool(okflag):
            return False, None, int(n_inl)
        # Verification tail: growth + GN refinement + loop-point projection
        # count, one device program.
        loop_mask = self._loop_point_mask(arena, cand)
        Rn, tn, sn, n_opt, n_total = _sim3_verify_program(
            arena, jnp.asarray(kf_id), jnp.asarray(cand), (R, t, s),
            m_idx, loop_mask, cfg, with_scale)
        n_opt, n_total = int(n_opt), int(n_total)
        if n_opt < MIN_BOW_MATCHES or n_total < MIN_ACCEPT_MATCHES:
            return False, None, n_total
        self.last_sim3 = (np.asarray(Rn), np.asarray(tn), float(sn))
        T = lie.rt_to_mat(float(sn) * Rn, tn)
        return True, T, n_total

    @staticmethod
    @jax.jit
    def _loop_point_mask(arena: ma.MapArena, cand) -> jnp.ndarray:
        """[pmax] bool: map points observed by the candidate's covisible
        group (mvpLoopMapPoints, LoopClosing.cc:305-320)."""
        group = (arena.covis[cand] > 0) | \
            (jnp.arange(arena.kmax) == cand)
        group = group & arena.kf_valid
        obs = jnp.where(group[:, None], arena.kf_obs, -1)
        mask = jnp.zeros(arena.pmax, bool)
        return mask.at[jnp.where(obs >= 0, obs, 0).reshape(-1)].max(
            (obs >= 0).reshape(-1))

    # -------------------------------------------------------------- correct
    def correct(self, arena: ma.MapArena, kf_id: int, cand: int,
                T_cur_cand: jnp.ndarray) -> ma.MapArena:
        """CorrectLoop: recompute the current keyframe's pose through the
        loop constraint, propagate to its covisible group and their points,
        then optimize the essential graph (Optimizer.cc:997-1260).

        With fix_scale=False (monocular) the whole correction runs over
        Sim3 — propagation carries the measured scale, the essential graph
        has 7-dof vertices, and poses/points are rescaled on write-back —
        so scale drift distributes around the loop (LoopClosing.cc:402-585
        with mg2oScw a true Sim3)."""
        if not self.fix_scale and self.last_sim3 is not None:
            return self._correct_sim3(arena, kf_id, cand)
        # Pre-correction poses: the essential-graph edge measurements must be
        # taken BEFORE any loop propagation (the reference's NonCorrectedSim3,
        # LoopClosing.cc:438-470) — otherwise every edge residual is zero and
        # the optimization is a no-op. Within the rigidly-propagated covisible
        # group relative poses are unchanged, so pre-poses are valid
        # measurements for ALL tree/covis edges; the loop edge alone carries
        # the RANSAC measurement T_cur_cand.
        pose_pre = arena.kf_pose

        # Corrected current pose: T_cw_corrected = T_cur_cand @ T_cand_w.
        T_corr = T_cur_cand @ arena.kf_pose[cand]
        T_old = arena.kf_pose[kf_id]

        # Propagate to the covisible group: each group pose keeps its
        # relative transform to the current keyframe,
        # T_i_corrected = (T_i @ T_cur_old^-1) @ T_cur_corrected.
        group = (arena.covis[kf_id] > 0) | \
            (jnp.arange(arena.kmax) == kf_id)
        group = group & arena.kf_valid
        rel = jnp.einsum("kij,jl->kil", arena.kf_pose, lie.se3_inverse(T_old))
        corrected = jnp.einsum("kij,jl->kil", rel, T_corr)
        new_poses = jnp.where(group[:, None, None], corrected, arena.kf_pose)

        # Points observed by the group move with the correction.
        pt_in_group = jnp.zeros(arena.pmax, bool)
        obs = jnp.where(group[:, None], arena.kf_obs, -1)
        pt_in_group = pt_in_group.at[
            jnp.where(obs >= 0, obs, 0).reshape(-1)].max((obs >= 0).reshape(-1))
        # world correction for points: x' = inv(T_corr) @ (T_old @ x)
        M = lie.se3_inverse(T_corr) @ T_old
        moved = lie.se3_apply(M, arena.pt_pos)
        arena = arena._replace(
            kf_pose=new_poses,
            pt_pos=jnp.where(pt_in_group[:, None], moved, arena.pt_pos))

        # Essential-graph optimization: tree/covis edges measured from the
        # pre-correction poses, the loop edge from the RANSAC transform, the
        # iteration initialized at the propagated (corrected) poses — drift
        # distributes from the loop edge through the graph.
        loop_i = jnp.asarray([kf_id], jnp.int32)
        loop_j = jnp.asarray([cand], jnp.int32)
        loop_T = T_cur_cand[None]
        edges = pose_graph.build_edges(
            pose_pre, arena.kf_valid, arena.kf_parent, arena.covis,
            loop_i, loop_j, loop_T, jnp.asarray([True]))
        new_kf_pose = pose_graph.optimize(arena.kf_pose, arena.kf_valid, edges)

        # Move each point with its reference keyframe's pose change.
        ref = jnp.clip(arena.pt_ref_kf, 0, arena.kmax - 1)
        T_oldref = arena.kf_pose[ref]
        T_newref = new_kf_pose[ref]
        M_pt = jax.vmap(lambda a, b: lie.se3_inverse(b) @ a)(T_oldref, T_newref)
        new_pts = jax.vmap(lie.se3_apply)(M_pt, arena.pt_pos)
        arena = arena._replace(
            kf_pose=new_kf_pose,
            pt_pos=jnp.where(arena.pt_valid[:, None], new_pts, arena.pt_pos))

        return self._finish_correct(arena, kf_id, cand, loop_T[0])

    def _correct_sim3(self, arena: ma.MapArena, kf_id: int,
                      cand: int) -> ma.MapArena:
        """The monocular CorrectLoop: Sim3 propagation + 7-dof essential
        graph + scale-aware pose/point write-back."""
        from gdslam_tpu.backend import pose_graph as pg
        R12 = jnp.asarray(self.last_sim3[0])
        t12 = jnp.asarray(self.last_sim3[1])
        s12 = jnp.asarray(self.last_sim3[2])
        pose_pre = arena.kf_pose
        K = arena.kmax

        # Corrected current vertex: S_corr = S12 o T_cand_w
        # (LoopClosing.cc:341 mScw = gScm * gSmw).
        Tc = arena.kf_pose[cand]
        Rcw, tcw, scw = lie.sim3_compose(R12, t12, s12,
                                         Tc[:3, :3], Tc[:3, 3], 1.0)
        T_old = arena.kf_pose[kf_id]

        # Propagate to the covisible group: S_i_prop = (T_i o T_old^-1) o
        # S_corr (CorrectedSim3, cc:438-470); non-group vertices keep their
        # SE3 pose at scale 1 (NonCorrectedSim3).
        group = (arena.covis[kf_id] > 0) | (jnp.arange(K) == kf_id)
        group = group & arena.kf_valid
        rel = jnp.einsum("kij,jl->kil", arena.kf_pose,
                         lie.se3_inverse(T_old))          # rigid, [K,4,4]
        Rg = jnp.einsum("kij,jl->kil", rel[:, :3, :3], Rcw)
        tg = jnp.einsum("kij,j->ki", rel[:, :3, :3], tcw) + rel[:, :3, 3]
        R_p = jnp.where(group[:, None, None], Rg, pose_pre[:, :3, :3])
        t_p = jnp.where(group[:, None], tg, pose_pre[:, :3, 3])
        s_p = jnp.where(group, scw, 1.0)

        # Group points move with the uniform Sim3 M = S_corr^-1 o T_old
        # (all group members share the same right factor, so the reference's
        # per-keyframe eigCorrectedP3Dw map collapses to one transform).
        pt_in_group = jnp.zeros(arena.pmax, bool)
        obs = jnp.where(group[:, None], arena.kf_obs, -1)
        pt_in_group = pt_in_group.at[
            jnp.where(obs >= 0, obs, 0).reshape(-1)].max(
            (obs >= 0).reshape(-1))
        Rmi, tmi, smi = lie.sim3_inverse(Rcw, tcw, scw)
        Rm, tm, sm = lie.sim3_compose(Rmi, tmi, smi,
                                      T_old[:3, :3], T_old[:3, 3], 1.0)
        moved = lie.sim3_apply(Rm, tm, sm, arena.pt_pos)
        arena = arena._replace(
            pt_pos=jnp.where(pt_in_group[:, None], moved, arena.pt_pos))

        # 7-dof essential graph: tree/covis measurements from the
        # pre-correction SE3 poses (scale 1), the loop edge from the
        # measured Sim3; initialized at the propagated vertices.
        loop_T = lie.rt_to_mat(R12, t12)[None]
        edges = pg.build_edges(
            pose_pre, arena.kf_valid, arena.kf_parent, arena.covis,
            jnp.asarray([kf_id], jnp.int32), jnp.asarray([cand], jnp.int32),
            loop_T, jnp.asarray([True]), loop_s=s12[None])
        R_n, t_n, s_n = pg.optimize_sim3_graph(
            R_p, t_p, s_p, arena.kf_valid, edges, fix_scale=False)

        # Point write-back: each point moves with its reference keyframe's
        # Sim3 change, x' = S_ref_new^-1(S_ref_prop(x)) (Optimizer.cc:1225-
        # 1250 vCorrectedSwc map).
        ref = jnp.clip(arena.pt_ref_kf, 0, K - 1)
        Ri_, ti_, si_ = jax.vmap(lie.sim3_inverse)(
            R_n[ref], t_n[ref], s_n[ref])
        Rpt, tpt, spt = jax.vmap(lie.sim3_compose)(
            Ri_, ti_, si_, R_p[ref], t_p[ref], s_p[ref])
        new_pts = jax.vmap(lie.sim3_apply)(Rpt, tpt, spt, arena.pt_pos)

        # Pose write-back: SE3 = [R | t/s] (Optimizer.cc:1235 eigt *= 1/s).
        new_kf_pose = lie.rt_to_mat(R_n, t_n / s_n[:, None])
        arena = arena._replace(
            kf_pose=jnp.where(arena.kf_valid[:, None, None], new_kf_pose,
                              arena.kf_pose),
            pt_pos=jnp.where(arena.pt_valid[:, None], new_pts, arena.pt_pos))
        T_meas = lie.rt_to_mat(s12 * R12, t12)
        return self._finish_correct(arena, kf_id, cand, T_meas)

    def _finish_correct(self, arena: ma.MapArena, kf_id: int, cand: int,
                        T_meas) -> ma.MapArena:
        # SearchAndFuse (LoopClosing.cc:525-560): with the poses corrected,
        # project the map into the current keyframe and its best covisible
        # neighbors and merge duplicate landmarks across the seam — the
        # loop-side and current-side copies of the same surface otherwise
        # stay as separate points that double-count observations in GBA.
        from gdslam_tpu.backend import gba, mapping
        w = np.asarray(arena.covis[kf_id])
        nbrs = [kf_id] + [int(k) for k in np.argsort(-w)[:4] if w[k] > 0]
        for k in nbrs:
            arena, _ = mapping.fuse_into_keyframe(arena, k, self.cfg)

        # Global BA after the loop (RunGlobalBundleAdjustment,
        # LoopClosing.cc:645-750) — synchronous here; the work is a handful
        # of device programs rather than a CPU thread.
        arena = gba.global_bundle_adjustment(arena, self.cfg,
                                             gate_outliers=True)

        self.last_loop_kf = kf_id
        self.loops.append((kf_id, cand, np.asarray(T_meas)))
        self._consistent = {}
        return arena

    # ----------------------------------------------------------------- main
    def process_keyframe(self, arena: ma.MapArena, kf_id: int) -> ma.MapArena:
        """Full per-keyframe loop-closing step (the Run loop body): every
        consistent candidate is geometrically verified in turn; the first
        to survive the Sim3 verification tail closes the loop
        (LoopClosing.cc:231-400 iterates nInitialCandidates)."""
        self.add_keyframe(arena, kf_id)
        for cand in self.detect(arena, kf_id):
            ok, T, n_inl = self.compute_transform(arena, kf_id, cand)
            if ok:
                return self.correct(arena, kf_id, cand, T)
        return arena
