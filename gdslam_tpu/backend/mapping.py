"""LocalMapping map-growth duties: epipolar triangulation + point upkeep.

Re-design of the reference LocalMapping map-growing stages:

- `create_new_map_points` — CreateNewMapPoints (LocalMapping.cc:207-453):
  triangulate unassociated keypoints of the new keyframe against its best
  covisible neighbors. The per-pair search (SearchForTriangulation +
  epipolar check, ORBmatcher.cc:657, 140) becomes one dense [N, N]
  Hamming matrix masked by the epipolar-line distance gate; the per-match
  SVD triangulation (LocalMapping.cc:300-320) is a vmapped 4x4 DLT; the
  parallax / cheirality / reprojection / scale-consistency gates
  (LocalMapping.cc:330-430) are vectorized boolean masks.
- `refresh_points` — MapPoint::ComputeDistinctiveDescriptors
  (MapPoint.cc:242-308, median-Hamming best descriptor) and
  UpdateNormalAndDepth (MapPoint.cc:330-371) over a sliding window of
  recent keyframes, run once per keyframe insertion for every point the
  new keyframe observes.
- `replace_duplicates` — MapPoint::Replace (MapPoint.cc:177) semantics for
  ORBmatcher::Fuse duplicate detection (ORBmatcher.cc:825-977): when one
  keypoint is claimed by two map points, the point with fewer observations
  is merged into the other via a dense redirect table over kf_obs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gdslam_tpu.backend import map_arena as ma
from gdslam_tpu.config import SlamConfig
from gdslam_tpu.core import camera as cam_ops
from gdslam_tpu.core import lie
from gdslam_tpu.ops import hamming, orb

# Host-side (numpy) constants on purpose: eager jnp constants created at
# trace time become device-array jaxpr consts that jax hoists into hidden
# executable parameters, and the C++ jit fastpath drops them on cache-hit
# replay ("Execution supplied N buffers but compiled program expected N+2").
# numpy values are baked into the HLO as literals instead.
_BIG = np.int32(1 << 20)
TH_LOW = 50


def _Kmat(cfg: SlamConfig) -> np.ndarray:
    c = cfg.camera
    return np.asarray([[c.fx, 0.0, c.cx], [0.0, c.fy, c.cy], [0.0, 0.0, 1.0]],
                      np.float32)


@partial(jax.jit, static_argnums=(2, 3))
def create_new_map_points(arena: ma.MapArena, kf_id, cfg: SlamConfig,
                          n_neighbors: int = 10) -> ma.MapArena:
    """Triangulate new map points for keyframe `kf_id` against its
    `n_neighbors` best covisible keyframes (LocalMapping.cc:207-453).

    Eligible keypoints: valid, unassociated, and without reliable depth
    (close-depth keypoints already became points at insertion; the reference
    prefers the stereo/depth measurement whenever its parallax beats the
    triangulation parallax, LocalMapping.cc:330-360).
    """
    cam = cfg.camera
    K = _Kmat(cfg)
    sf = float(cfg.orb.scale_factor)
    n_levels = cfg.orb.n_levels
    N = arena.n_features
    ratio_factor = 1.5 * sf

    n_neighbors = min(n_neighbors, arena.kmax - 1)
    # Neighbor selection: best covisible keyframes; the temporal predecessor
    # always participates (a freshly-split map can have zero covisibility
    # while still sharing a view — the reference seeds covisibility through
    # tracked points, which may not exist yet for mono/low-depth scenes).
    w = arena.covis[kf_id]
    w = w.at[jnp.maximum(kf_id - 1, 0)].add(1)
    w = jnp.where(arena.kf_valid, w, -1).at[kf_id].set(-1)
    top_w, nb_ids = jax.lax.top_k(w, n_neighbors)
    nb_ok = (top_w > 0) & (nb_ids < arena.n_kf)

    T1 = arena.kf_pose[kf_id]
    R1, t1 = T1[:3, :3], T1[:3, 3]
    o1 = -R1.T @ t1
    uv1 = arena.kf_uv[kf_id]
    lvl1 = arena.kf_level[kf_id]
    desc1 = arena.kf_desc[kf_id]
    th_depth_m = cam.bf * cam.th_depth / cam.fx
    sigma2_1 = sf ** (2.0 * lvl1.astype(jnp.float32))

    def one_neighbor(arena, nb):
        nb_id, ok = nb
        free1 = arena.kf_kp_valid[kf_id] & (arena.kf_obs[kf_id] < 0) & \
            ((arena.kf_depth[kf_id] <= 0) |
             (arena.kf_depth[kf_id] > th_depth_m))
        T2 = arena.kf_pose[nb_id]
        R2, t2 = T2[:3, :3], T2[:3, 3]
        o2 = -R2.T @ t2
        uv2 = arena.kf_uv[nb_id]
        lvl2 = arena.kf_level[nb_id]
        free2 = arena.kf_kp_valid[nb_id] & (arena.kf_obs[nb_id] < 0) & \
            ((arena.kf_depth[nb_id] <= 0) |
             (arena.kf_depth[nb_id] > th_depth_m))
        # Baseline gate (LocalMapping.cc:246-268): for RGB-D/stereo the
        # baseline must exceed the stereo baseline (metric); for MONOCULAR
        # frames (no depth measurements) the reference gates on
        # baseline / medianSceneDepth >= 0.01 instead — a mono map's gauge
        # is arbitrary, so no metric threshold is meaningful.
        baseline = jnp.linalg.norm(o2 - o1)
        has_depth = jnp.any(arena.kf_depth[kf_id] > 0)
        obs2 = arena.kf_obs[nb_id]
        has2 = (obs2 >= 0) & arena.pt_valid[jnp.maximum(obs2, 0)]
        z2 = lie.se3_apply(T2, arena.pt_pos[jnp.maximum(obs2, 0)])[:, 2]
        med2 = jnp.nanmedian(jnp.where(has2, z2, jnp.nan))
        med2 = jnp.where(jnp.isfinite(med2), med2, 1.0)
        ok = ok & jnp.where(has_depth, baseline > cam.bf / cam.fx,
                            baseline / jnp.maximum(med2, 1e-6) >= 0.01)

        # Fundamental matrix F12 = K^-T [t12]x R12 K^-1 (ComputeF12,
        # LocalMapping.cc:573-588).
        R12 = R1 @ R2.T
        t12 = -R12 @ t2 + t1
        tx = jnp.asarray([[0.0, -t12[2], t12[1]],
                          [t12[2], 0.0, -t12[0]],
                          [-t12[1], t12[0], 0.0]])
        Kinv = jnp.linalg.inv(K)
        F12 = Kinv.T @ tx @ R12 @ Kinv

        # Epipolar line of kp1 in image 2: l2 = F12^T x1.
        x1h = jnp.concatenate([uv1, jnp.ones((N, 1))], axis=1)       # [N, 3]
        l2 = x1h @ F12                                               # [N, 3]
        num = l2[:, None, 0] * uv2[None, :, 0] + \
            l2[:, None, 1] * uv2[None, :, 1] + l2[:, None, 2]
        den = l2[:, 0] ** 2 + l2[:, 1] ** 2
        dsq = (num * num) / jnp.maximum(den[:, None], 1e-12)
        sigma2_2 = sf ** (2.0 * lvl2.astype(jnp.float32))
        epi_ok = dsq < 3.84 * sigma2_2[None, :]      # CheckDistEpipolarLine

        ham = hamming.hamming_matrix(
            orb.descriptors_pm1(desc1, free1),
            orb.descriptors_pm1(arena.kf_desc[nb_id], free2))
        cost = jnp.where(epi_ok & free1[:, None] & free2[None, :], ham, _BIG)
        best, _, arg = hamming.best_two(cost, axis=1)                # per kp1
        matched = best <= TH_LOW
        # one-to-one: kp2 keeps only its best kp1
        best_col = jnp.min(cost, axis=0)
        matched = matched & (best <= best_col[arg])

        i2 = jnp.where(matched, arg, 0)
        # Triangulate: two-ray midpoint (closed form). The reference's SVD
        # DLT (LocalMapping.cc:300-320) costs ~15k tiny SVDs per keyframe;
        # the midpoint of the common perpendicular is arithmetic only,
        # and the parallax/reprojection gates below reject the cases where
        # the two differ.
        Kinv_ = Kinv
        r1d = jnp.einsum("ji,nj->ni", R1,
                         jnp.einsum("ij,nj->ni", Kinv_,
                                    jnp.concatenate([uv1, jnp.ones((N, 1))], 1)))
        uv2m = uv2[i2]
        r2d = jnp.einsum("ji,nj->ni", R2,
                         jnp.einsum("ij,nj->ni", Kinv_,
                                    jnp.concatenate([uv2m, jnp.ones((N, 1))], 1)))
        # solve [d1.d1  -d1.d2; d1.d2  -d2.d2] [s;t] = [d1.(o2-o1); d2.(o2-o1)]
        d11 = jnp.sum(r1d * r1d, axis=1)
        d22 = jnp.sum(r2d * r2d, axis=1)
        d12 = jnp.sum(r1d * r2d, axis=1)
        b_vec = o2 - o1
        b1 = r1d @ b_vec
        b2 = r2d @ b_vec
        den = d11 * d22 - d12 * d12
        den = jnp.where(jnp.abs(den) > 1e-12, den, 1e-12)
        s_par = (b1 * d22 - b2 * d12) / den
        t_par = (b1 * d12 - b2 * d11) / den
        Xw = 0.5 * ((o1 + s_par[:, None] * r1d) + (o2 + t_par[:, None] * r2d))
        # Parallax gate: rays must subtend a usable angle.
        r1 = Xw - o1
        r2 = Xw - o2
        d1 = jnp.linalg.norm(r1, axis=1)
        d2 = jnp.linalg.norm(r2, axis=1)
        cos_par = jnp.sum(r1 * r2, axis=1) / jnp.maximum(d1 * d2, 1e-9)
        par_ok = (cos_par > 0) & (cos_par < 0.9998)
        # Cheirality + reprojection in both views.
        X1 = lie.se3_apply(T1, Xw)
        X2 = lie.se3_apply(T2, Xw)
        uvp1, z1 = cam_ops.project(X1, cam)
        uvp2, z2 = cam_ops.project(X2, cam)
        e1 = jnp.sum((uvp1 - uv1) ** 2, axis=1)
        e2 = jnp.sum((uvp2 - uv2[i2]) ** 2, axis=1)
        reproj_ok = (z1 > 0) & (z2 > 0) & \
            (e1 < 5.991 * sigma2_1) & (e2 < 5.991 * sigma2_2[i2])
        # Scale consistency (LocalMapping.cc:410-428).
        ratio_dist = d2 / jnp.maximum(d1, 1e-9)
        ratio_oct = sf ** (lvl1 - lvl2[i2]).astype(jnp.float32)
        scale_ok = (ratio_dist * ratio_factor > ratio_oct) & \
            (ratio_dist < ratio_oct * ratio_factor)

        create = matched & par_ok & reproj_ok & scale_ok & ok
        order = jnp.cumsum(create.astype(jnp.int32)) - 1
        create = create & (arena.n_pt + order < arena.pmax)
        slot = jnp.where(create, arena.n_pt + order, 0)

        normal = (r1 / jnp.maximum(d1[:, None], 1e-9) +
                  r2 / jnp.maximum(d2[:, None], 1e-9))
        normal = normal / jnp.maximum(
            jnp.linalg.norm(normal, axis=1, keepdims=True), 1e-9)
        max_d = d1 * sf ** lvl1.astype(jnp.float32)
        min_d = max_d / (sf ** (n_levels - 1))

        def scatter(dst, src):
            return dst.at[slot].set(jnp.where(
                create.reshape((-1,) + (1,) * (src.ndim - 1)), src, dst[slot]))

        slot32 = slot.astype(jnp.int32)
        obs1_new = jnp.where(create, slot32, arena.kf_obs[kf_id])
        # scatter into neighbor's obs row at kp index i2
        obs2_row = arena.kf_obs[nb_id].at[i2].set(
            jnp.where(create, slot32, arena.kf_obs[nb_id][i2]))
        arena = arena._replace(
            pt_pos=scatter(arena.pt_pos, Xw),
            pt_desc=scatter(arena.pt_desc, desc1),
            pt_normal=scatter(arena.pt_normal, normal),
            pt_min_dist=scatter(arena.pt_min_dist, min_d),
            pt_max_dist=scatter(arena.pt_max_dist, max_d),
            pt_valid=arena.pt_valid.at[slot].set(
                jnp.where(create, True, arena.pt_valid[slot])),
            pt_ref_kf=scatter(arena.pt_ref_kf,
                              jnp.full_like(slot32, kf_id)),
            pt_n_obs=scatter(arena.pt_n_obs, jnp.full_like(slot32, 2)),
            n_pt=jnp.minimum(arena.n_pt + jnp.sum(create), arena.pmax),
            kf_obs=arena.kf_obs.at[kf_id].set(obs1_new)
                                .at[nb_id].set(obs2_row),
        )
        return arena, jnp.sum(create)

    for k in range(n_neighbors):
        arena, _ = one_neighbor(arena, (nb_ids[k], nb_ok[k]))
    return ma.update_covisibility(arena, kf_id)


@partial(jax.jit, static_argnums=(2, 3))
def refresh_points(arena: ma.MapArena, kf_id, cfg: SlamConfig,
                   window: int = 8) -> ma.MapArena:
    """Recompute distinctive descriptors + normals/depth ranges for every
    point the keyframe `kf_id` observes, using its observations in the last
    `window` keyframes.

    MapPoint::ComputeDistinctiveDescriptors (MapPoint.cc:242-308): among the
    observing keyframes' descriptors, keep the one with least median Hamming
    distance to the rest. UpdateNormalAndDepth (MapPoint.cc:330-371): normal
    = mean unit ray from observing camera centers; scale range from the
    newest observation's level. The reference walks all observations through
    the pointer graph; here a fixed recent-keyframe window bounds the
    shapes, PLUS each point's reference keyframe as one extra candidate:
    long-lived points re-observed after a loop would otherwise get purely
    recency-biased descriptors, while the reference's all-observations
    median keeps the loop-side appearance in the vote — the ref-KF
    (birth-side) descriptor restores exactly that constituency at O(1)
    extra candidates.
    """
    N = arena.n_features
    W = window
    base = jnp.maximum(kf_id - W + 1, 0)
    rows = base + jnp.arange(W)                              # [W]
    row_ok = (rows <= kf_id) & arena.kf_valid[rows]

    touched = arena.kf_obs[kf_id]                            # [N] point ids
    t_ok = touched >= 0
    t_idx = jnp.where(t_ok, touched, arena.pmax - 1)

    # Inverse map: for each window keyframe, point id -> keypoint index.
    obs_w = arena.kf_obs[rows]                               # [W, N]
    inv = jnp.full((W, arena.pmax), -1, jnp.int32)
    kp_iota = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (W, N))
    inv = inv.at[jnp.arange(W)[:, None],
                 jnp.where(obs_w >= 0, obs_w, 0)].set(
        jnp.where(obs_w >= 0, kp_iota, -1))

    kp_in_w = inv[:, t_idx]                                  # [W, N]
    has = (kp_in_w >= 0) & row_ok[:, None] & t_ok[None, :]
    kp_safe = jnp.maximum(kp_in_w, 0)
    # candidate descriptors: [W, N, 32]
    cand = arena.kf_desc[rows[:, None], kp_safe]
    cand_n = jnp.transpose(cand, (1, 0, 2))                  # [N, W, 32]

    # Extra candidate: the point's reference-keyframe (birth) observation,
    # skipped when that keyframe already sits inside the recency window.
    ref_rows = jnp.clip(arena.pt_ref_kf[t_idx], 0, arena.kmax - 1)  # [N]
    eq = arena.kf_obs[ref_rows] == t_idx[:, None]            # [N, N]
    ref_kp = jnp.argmax(eq, axis=1).astype(jnp.int32)
    ref_has = jnp.any(eq, axis=1) & t_ok & \
        (arena.pt_ref_kf[t_idx] >= 0) & arena.kf_valid[ref_rows] & \
        ~((ref_rows >= base) & (ref_rows <= kf_id))
    ref_desc = arena.kf_desc[ref_rows, ref_kp]               # [N, 32]
    cand_n = jnp.concatenate([cand_n, ref_desc[:, None, :]], axis=1)
    ham = hamming.hamming_packed(cand_n[:, :, None, :],
                                 cand_n[:, None, :, :])      # [N, W+1, W+1]
    has_n = jnp.concatenate([jnp.transpose(has), ref_has[:, None]],
                            axis=1)                          # [N, W+1]
    pair_ok = has_n[:, :, None] & has_n[:, None, :]
    # median distance per candidate: sort with invalid -> +inf, take the
    # element at (count-1)//2 like the reference's vDists[0.5*(N-1)]
    hmask = jnp.where(pair_ok, ham.astype(jnp.float32), jnp.inf)
    hsort = jnp.sort(hmask, axis=2)
    cnt = jnp.sum(pair_ok, axis=2)                           # [N, W]
    med_idx = jnp.maximum((cnt - 1) // 2, 0)
    med = jnp.take_along_axis(hsort, med_idx[..., None], axis=2)[..., 0]
    med = jnp.where(has_n, med, jnp.inf)
    best_w = jnp.argmin(med, axis=1)                         # [N]
    n_cand = jnp.sum(has_n, axis=1)
    new_desc = cand_n[jnp.arange(N), best_w]                 # [N, 32]
    upd = t_ok & (n_cand >= 2) & jnp.isfinite(
        med[jnp.arange(N), best_w])

    # Normals: mean unit ray over the window's observing centers.
    Rw = arena.kf_pose[rows][:, :3, :3]
    tw = arena.kf_pose[rows][:, :3, 3]
    centers = -jnp.einsum("wij,wi->wj", Rw, tw)              # [W, 3]
    pos = arena.pt_pos[t_idx]                                # [N, 3]
    rays = pos[None, :, :] - centers[:, None, :]             # [W, N, 3]
    rays = rays / jnp.maximum(
        jnp.linalg.norm(rays, axis=2, keepdims=True), 1e-9)
    rays = jnp.where(has[..., None], rays, 0.0)
    nsum = jnp.sum(rays, axis=0)                             # [N, 3]
    # reference-keyframe observation contributes its ray too
    T_ref = arena.kf_pose[ref_rows]                          # [N, 4, 4]
    c_ref = -jnp.einsum("nij,ni->nj", T_ref[:, :3, :3], T_ref[:, :3, 3])
    r_ref = pos - c_ref
    r_ref = r_ref / jnp.maximum(
        jnp.linalg.norm(r_ref, axis=1, keepdims=True), 1e-9)
    nsum = nsum + jnp.where(ref_has[:, None], r_ref, 0.0)
    nnorm = jnp.linalg.norm(nsum, axis=1, keepdims=True)
    new_normal = nsum / jnp.maximum(nnorm, 1e-9)

    # Depth range from the newest observation (kf_id itself).
    T_new = arena.kf_pose[kf_id]
    o_new = -T_new[:3, :3].T @ T_new[:3, 3]
    dist = jnp.linalg.norm(pos - o_new[None], axis=1)
    sf = float(cfg.orb.scale_factor)
    lvl = arena.kf_level[kf_id].astype(jnp.float32)
    max_d = dist * sf ** lvl
    min_d = max_d / (sf ** (cfg.orb.n_levels - 1))

    # Masked-out rows target the out-of-range index pmax and are DROPPED —
    # never reuse a live slot as a dump (duplicate-index .set order is
    # unspecified and would clobber a genuine update to that slot).
    tgt = jnp.where(upd, t_idx, arena.pmax)
    arena = arena._replace(
        pt_desc=arena.pt_desc.at[tgt].set(new_desc, mode="drop"),
        pt_normal=arena.pt_normal.at[tgt].set(new_normal, mode="drop"),
        pt_min_dist=arena.pt_min_dist.at[tgt].set(min_d, mode="drop"),
        pt_max_dist=arena.pt_max_dist.at[tgt].set(max_d, mode="drop"),
    )
    return arena


@partial(jax.jit, static_argnums=(2,))
def fuse_into_keyframe(arena: ma.MapArena, kf_id, cfg: SlamConfig):
    """ORBmatcher::Fuse into the new keyframe (ORBmatcher.cc:825-977, driven
    by LocalMapping::SearchInNeighbors LocalMapping.cc:454-535): project all
    valid map points into keyframe `kf_id`; a matched keypoint that is free
    gains the observation, a matched keypoint already claimed by a DIFFERENT
    point triggers MapPoint::Replace — the point with fewer observations is
    merged into the other. Returns (arena, kf_id's refreshed obs row)."""
    from gdslam_tpu.frontend import extractor, matcher
    cam = cfg.camera
    sfs = extractor.scale_factors(cfg.orb)
    T = arena.kf_pose[kf_id]
    uv_p, level_p, radius_p, vis = matcher.project_for_search(
        arena.pt_pos, arena.pt_valid, T,
        (cam.fx, cam.fy, cam.cx, cam.cy), (cam.width, cam.height), sfs,
        pt_max_dist=arena.pt_max_dist, pt_normal=arena.pt_normal,
        base_radius=3.0)
    cap = min(4096, arena.pmax)
    score = jnp.where(vis, 1 + arena.pt_n_obs, 0)
    # exact selection; float32 (small integer scores, exact) is XLA:CPU's
    # fast top_k path
    _, cand_ids = jax.lax.top_k(score.astype(jnp.float32), cap)
    cand_ids = cand_ids.astype(jnp.int32)
    cvalid = vis[cand_ids]
    kp_valid = arena.kf_kp_valid[kf_id]
    res = matcher.match_candidates(
        uv_p[cand_ids], cvalid,
        orb.descriptors_pm1(arena.pt_desc[cand_ids], cvalid),
        level_p[cand_ids], jnp.zeros(cap), radius_p[cand_ids],
        arena.kf_uv[kf_id], kp_valid,
        orb.descriptors_pm1(arena.kf_desc[kf_id], kp_valid),
        arena.kf_level[kf_id], arena.kf_angle[kf_id],
        th_hamming=TH_LOW, level_slack=1, use_rotation=False)
    matched = res.point_idx >= 0
    cand_pt = cand_ids[jnp.where(matched, res.point_idx, 0)].astype(jnp.int32)
    cur_pt = arena.kf_obs[kf_id]
    # Case 1: free keypoint gains the observation — unless the point is
    # already observed by another keypoint of this keyframe (keeps the
    # one-observation-per-point-per-keyframe invariant BA relies on).
    in_row = jnp.zeros(arena.pmax + 1, bool).at[
        jnp.where(cur_pt >= 0, cur_pt, arena.pmax)].set(True)
    gain = matched & (cur_pt < 0) & ~in_row[cand_pt]
    obs_row = jnp.where(gain, cand_pt, cur_pt)
    arena = arena._replace(
        kf_obs=arena.kf_obs.at[kf_id].set(obs_row),
        pt_n_obs=arena.pt_n_obs.at[
            jnp.where(gain, cand_pt, arena.pmax - 1)].add(
            gain.astype(jnp.int32)))
    # Case 2: keypoint claimed by a different point -> Replace (keep the
    # point with more observations).
    dup = matched & (cur_pt >= 0) & (cand_pt != cur_pt)
    a, b = cand_pt, jnp.maximum(cur_pt, 0)
    a_wins = arena.pt_n_obs[a] >= arena.pt_n_obs[b]
    dst = jnp.where(a_wins, a, b)
    src = jnp.where(a_wins, b, a)
    arena = replace_points(arena, src, dst, dup)
    return arena, jnp.where(arena.kf_kp_valid[kf_id],
                            arena.kf_obs[kf_id], -1)


@jax.jit
def replace_points(arena: ma.MapArena, src: jnp.ndarray, dst: jnp.ndarray,
                   do: jnp.ndarray) -> ma.MapArena:
    """MapPoint::Replace (MapPoint.cc:177): merge point `src` into `dst`.

    src/dst: [M] int32 point ids, do: [M] bool. Every kf_obs entry pointing
    at src is redirected to dst; src is invalidated; counters accumulate.
    One-step redirects only (chains resolve over subsequent calls).
    """
    P = arena.pmax
    redirect = jnp.arange(P, dtype=jnp.int32)
    s = jnp.where(do, src, P - 1)
    # masked write: where not `do`, write identity back
    redirect = redirect.at[s].set(jnp.where(do, dst, redirect[s]))
    obs = arena.kf_obs
    obs = jnp.where(obs >= 0, redirect[jnp.maximum(obs, 0)], obs)
    inc = lambda a: a.at[jnp.where(do, dst, P - 1)].add(
        jnp.where(do, a[jnp.where(do, src, P - 1)], 0))
    valid = arena.pt_valid.at[s].set(
        jnp.where(do, False, arena.pt_valid[s]))
    return arena._replace(
        kf_obs=obs,
        pt_valid=valid,
        pt_n_obs=inc(arena.pt_n_obs),
        pt_found=inc(arena.pt_found),
        pt_visible=inc(arena.pt_visible),
    )
