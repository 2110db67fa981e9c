"""Local bundle adjustment: masked dense Gauss-Newton with Schur complement.

Replaces Optimizer::LocalBundleAdjustment (reference Optimizer.cc:669-995):
optimize the covisible local keyframes + their map points, with keyframes
that observe those points but are outside the local set held fixed; two
passes (5 then 10 iterations) with chi2-based outlier edge removal between
and after (5.991 mono / 7.815 stereo), Huber robust kernel.

Design: no sparse graph. The edge set is the dense [A, N] keyframe x
keypoint observation table (A = local + fixed keyframes, N = features per
keyframe, invalid entries masked), so residuals/Jacobians are one vmapped
computation; the point-block inverse is a closed-form batched 3x3; the
reduced camera system (6L x 6L with L <= 16) is built with einsums over a
dense [L, P, 6, 3] coupling tensor and solved with Cholesky. At TUM scale
this puts the whole BA in one XLA program with zero host round-trips.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gdslam_tpu.backend import map_arena as ma
from gdslam_tpu.backend.optimizer import CHI2_MONO, CHI2_STEREO
from gdslam_tpu.config import SlamConfig
from gdslam_tpu.core import lie

_PREC = jax.lax.Precision.HIGHEST

L_OPT = 16      # optimized local keyframes (covisibility cap)
F_FIX = 16      # fixed observer keyframes
P_CAP = 8192    # local map points


class LocalBAProblem(NamedTuple):
    kf_ids: jnp.ndarray      # [L+F] arena keyframe ids (first L optimized)
    kf_mask: jnp.ndarray     # [L+F] valid
    pt_ids: jnp.ndarray      # [P] arena point ids
    pt_mask: jnp.ndarray     # [P] valid
    obs_slot: jnp.ndarray    # [L+F, N] local point slot per keypoint (-1)
    inv_idx: jnp.ndarray     # [L+F, P] keypoint index observing slot p (N=none)


@partial(jax.jit, static_argnums=(2,))
def build_problem(arena: ma.MapArena, kf_id, cfg: SlamConfig) -> LocalBAProblem:
    # Local keyframes: top covisible of kf_id (including itself).
    loc_ids, loc_ok = ma.local_keyframes(arena, kf_id, L_OPT)

    # Local points: union of observations of local keyframes.
    is_local_kf = jnp.zeros(arena.kmax, bool).at[
        jnp.where(loc_ok, loc_ids, 0)].set(loc_ok)
    obs_local = jnp.where((is_local_kf[:, None] & (arena.kf_obs >= 0)),
                          arena.kf_obs, arena.pmax)
    pt_ind = jnp.zeros(arena.pmax + 1, bool).at[obs_local.reshape(-1)].set(
        True).at[arena.pmax].set(False)
    pt_ind = pt_ind[:arena.pmax] & arena.pt_valid
    pt_ids = jnp.nonzero(pt_ind, size=P_CAP, fill_value=-1)[0]
    pt_mask = pt_ids >= 0
    slot_of = jnp.full(arena.pmax + 1, -1, jnp.int32).at[
        jnp.where(pt_mask, pt_ids, arena.pmax)].set(
        jnp.where(pt_mask, jnp.arange(P_CAP, dtype=jnp.int32), -1))

    # Fixed keyframes: observe local points, not local themselves.
    sees = jnp.sum(jnp.take(pt_ind, jnp.where(arena.kf_obs >= 0,
                                              arena.kf_obs, 0), axis=0)
                   & (arena.kf_obs >= 0), axis=1)
    sees = jnp.where(arena.kf_valid & ~is_local_kf, sees, 0)
    # tiny arenas (kmax < F_FIX): pad so the problem shape stays [L+F]
    if arena.kmax < F_FIX:
        sees = jnp.pad(sees, (0, F_FIX - arena.kmax))
    fix_w, fix_ids = jax.lax.top_k(sees, F_FIX)
    fix_ids = jnp.minimum(fix_ids, arena.kmax - 1)
    fix_ok = fix_w > 0

    kf_ids = jnp.concatenate([loc_ids, fix_ids])
    kf_mask = jnp.concatenate([loc_ok, fix_ok])
    obs = arena.kf_obs[kf_ids]                       # [A, N]
    obs_slot = jnp.where(kf_mask[:, None] & (obs >= 0),
                         slot_of[jnp.where(obs >= 0, obs, arena.pmax)], -1)
    # Uniqueness invariant: a keyframe observes a point through at most one
    # keypoint. Point merges (MapPoint::Replace) can leave duplicate rows;
    # keep only the first so run_local_ba may use unique-indices scatters.
    A = obs_slot.shape[0]
    order = jnp.argsort(obs_slot, axis=1)
    ssort = jnp.take_along_axis(obs_slot, order, axis=1)
    prev = jnp.concatenate([jnp.full((A, 1), -2, ssort.dtype),
                            ssort[:, :-1]], axis=1)
    dup_sorted = (ssort == prev) & (ssort >= 0)
    rows = jnp.arange(A)[:, None]
    dup = jnp.zeros_like(dup_sorted).at[rows, order].set(dup_sorted)
    obs_slot = jnp.where(dup, -1, obs_slot)
    # Inverse map [A, P]: which keypoint row observes point slot p in camera
    # a (N = none). Built ONCE here so every GN iteration can GATHER the
    # per-point blocks instead of scatter-adding them into [A, P, 30]
    # accumulation buffers (serialized scatters + inter-iteration buffer
    # copies).
    N = obs_slot.shape[1]
    slot_pos = jnp.where(obs_slot >= 0, obs_slot, P_CAP)
    inv_idx = jnp.full((A, P_CAP + 1), N, jnp.int32).at[
        jnp.arange(A)[:, None], slot_pos].set(
        jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None], (A, N))
    )[:, :P_CAP]
    return LocalBAProblem(kf_ids=kf_ids, kf_mask=kf_mask, pt_ids=pt_ids,
                          pt_mask=pt_mask, obs_slot=obs_slot,
                          inv_idx=inv_idx)


def _edge_terms(poses, pts, prob: LocalBAProblem, uv, ur, inv_sigma2, K, bf):
    """Residuals r [A,N,3], Jacobians Jc [A,N,3,6], Jp [A,N,3,3], weights."""
    fx, fy, cx, cy = K
    A, N = prob.obs_slot.shape
    slot = jnp.maximum(prob.obs_slot, 0)
    Xw = pts[slot]                                   # [A, N, 3]
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    Xc = jnp.einsum("aij,anj->ani", R, Xw, precision=_PREC) + t[:, None]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_ok = z > 1e-6
    iz = 1.0 / jnp.where(z_ok, z, 1.0)
    iz2 = iz * iz
    u_hat = fx * x * iz + cx
    v_hat = fy * y * iz + cy
    ur_hat = u_hat - bf * iz
    is_stereo = ur >= 0
    r = jnp.stack([u_hat - uv[..., 0], v_hat - uv[..., 1],
                   jnp.where(is_stereo, ur_hat - ur, 0.0)], axis=-1)
    zero = jnp.zeros_like(x)
    du = jnp.stack([fx * iz, zero, -fx * x * iz2], -1)
    dv = jnp.stack([zero, fy * iz, -fy * y * iz2], -1)
    dur = jnp.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], -1)
    dproj = jnp.stack([du, dv, jnp.where(is_stereo[..., None], dur, 0.0)], -2)
    # [A,N,3res,3cam]
    dXc_pose = jnp.concatenate([
        jnp.broadcast_to(jnp.eye(3), Xc.shape + (3,)), -lie.hat(Xc)], axis=-1)
    Jc = jnp.einsum("anri,anik->anrk", dproj, dXc_pose, precision=_PREC)
    Jp = jnp.einsum("anri,aik->anrk", dproj, R, precision=_PREC)
    valid = (prob.obs_slot >= 0) & z_ok
    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    e2 = jnp.sum(r * r, axis=-1) * inv_sigma2
    w_huber = jnp.where(e2 <= chi2_th, 1.0,
                        jnp.sqrt(chi2_th / jnp.maximum(e2, 1e-12)))
    return r, Jc, Jp, valid, e2, w_huber * inv_sigma2


def _inv3x3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    e, f, i = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    det = a * (e * i - f * f) - b * (b * i - f * c) + c * (b * f - e * c)
    det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    inv = jnp.stack([
        jnp.stack([e * i - f * f, c * f - b * i, b * f - c * e], -1),
        jnp.stack([c * f - b * i, a * i - c * c, b * c - a * f], -1),
        jnp.stack([b * f - c * e, b * c - a * f, a * e - b * b], -1),
    ], -2)
    return inv / det[..., None, None]


@partial(jax.jit, static_argnums=(2, 3, 4, 6, 7))
def run_local_ba(arena: ma.MapArena, prob: LocalBAProblem, cfg: SlamConfig,
                 iters1: int = 5, iters2: int = 10, key=None,
                 damping: float = 1e-3, cull: bool = True):
    """Execute local BA; returns (arena', n_outlier_obs)."""
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    bf = cam.bf
    sf = float(cfg.orb.scale_factor)
    A = prob.obs_slot.shape[0]
    L = L_OPT

    poses0 = arena.kf_pose[prob.kf_ids]              # [A,4,4]
    pts0 = arena.pt_pos[jnp.maximum(prob.pt_ids, 0)]  # [P,3]
    uv = arena.kf_uv[prob.kf_ids]
    ur = arena.kf_ur[prob.kf_ids]
    inv_sigma2 = 1.0 / sf ** (2.0 * arena.kf_level[prob.kf_ids].astype(jnp.float32))

    chi2_th_all = jnp.where(ur >= 0, CHI2_STEREO, CHI2_MONO)

    def robust_cost(poses, pts, inlier):
        """Huber-robustified total chi2 — the LM acceptance criterion.

        Edge set frozen to the state-independent mask: an edge whose point
        leaves the camera frustum (z <= 0) at the evaluated state pays a
        saturated penalty instead of dropping out, so a step cannot be
        accepted BECAUSE it pushed points behind the camera."""
        _, _, _, valid, e2, _ = _edge_terms(poses, pts, prob, uv, ur,
                                            inv_sigma2, K, bf)
        structural = (prob.obs_slot >= 0) & inlier
        rho = jnp.where(e2 <= chi2_th_all, e2,
                        2.0 * jnp.sqrt(chi2_th_all * jnp.maximum(e2, 0.0))
                        - chi2_th_all)
        rho_sat = 2.0 * jnp.sqrt(chi2_th_all * 1e8) - chi2_th_all
        return jnp.sum(jnp.where(structural,
                                 jnp.where(valid, rho, rho_sat), 0.0))

    def gn_iter(state, inlier):
        # Levenberg-Marquardt control (the reference optimizes with g2o LM,
        # Optimizer.cc:751): compute the damped GN step, accept only if the
        # robust cost decreases, adapt lambda. Plain GN diverged
        # catastrophically when a revisit seam's large residuals entered the
        # problem (measured: a keyframe insertion flipping its own pose to
        # negative median depth, then successive BAs wrecking neighbors).
        poses, pts, lam, cost = state
        r, Jc, Jp, valid, e2, w = _edge_terms(poses, pts, prob, uv, ur,
                                              inv_sigma2, K, bf)
        w = w * (valid & inlier)
        slot = jnp.maximum(prob.obs_slot, 0)

        # Camera blocks (only first L optimized).
        Hcc = jnp.einsum("anri,an,anrj->aij", Jc, w, Jc, precision=_PREC)[:L]
        bc = jnp.einsum("anri,an,anr->ai", Jc, w, r, precision=_PREC)[:L]
        # Point blocks: one flat scatter-add over all [A*N] edges into the
        # small [P,12] accumulator.
        JpwJp = jnp.einsum("anri,an,anrj->anij", Jp, w, Jp,
                           precision=_PREC).reshape(A, -1, 9)
        Jpwr = jnp.einsum("anri,an,anr->ani", Jp, w, r, precision=_PREC)
        pt_blocks = jnp.concatenate([JpwJp, Jpwr], axis=-1)      # [A,N,12]
        flat_slot = jnp.where(prob.obs_slot >= 0, slot, P_CAP).reshape(-1)
        acc = jnp.zeros((P_CAP + 1, 12)).at[flat_slot].add(
            pt_blocks.reshape(-1, 12))[:P_CAP]
        Hpp = acc[:, :9].reshape(P_CAP, 3, 3)
        # Marquardt damping: scale the diagonal (lam is relative, so the
        # pixel-unit magnitudes of Hpp/S don't matter) + small absolute
        # floor to keep empty blocks invertible.
        Hpp = Hpp + lam * Hpp * jnp.eye(3) + damping * jnp.eye(3)
        bp = acc[:, 9:12]
        # Camera-point coupling W: needed only for the L optimized cameras.
        # A keyframe observes each point through at most ONE keypoint
        # (duplicates masked in build_problem), so [L,N] -> [L,P] is a pure
        # permutation: GATHER through the precomputed inverse index — a
        # scatter here serializes and forces large buffer copies every GN
        # iteration.
        JcwJp = jnp.einsum("anri,an,anrj->anij", Jc[:L], w[:L], Jp[:L],
                           precision=_PREC).reshape(L, -1, 18)
        JcwJp_ext = jnp.concatenate(
            [JcwJp, jnp.zeros((L, 1, 18))], axis=1)              # row N = none
        Wap = jnp.take_along_axis(
            JcwJp_ext, prob.inv_idx[:L, :, None], axis=1
        ).reshape(L, P_CAP, 6, 3)
        Hpp_inv = _inv3x3(Hpp)
        # Schur complement S = Hcc - W Hpp^-1 W^T (cross-camera coupling).
        WH = jnp.einsum("apij,pjk->apik", Wap, Hpp_inv, precision=_PREC)
        S_cross = jnp.einsum("apik,bplk->abil", WH, Wap, precision=_PREC)
        S = -S_cross
        S = S.at[jnp.arange(L), jnp.arange(L)].add(Hcc)
        bs = bc - jnp.einsum("apik,pk->ai", WH, bp, precision=_PREC)
        S_m = S.transpose(0, 2, 1, 3).reshape(6 * L, 6 * L)
        S_m = S_m + lam * S_m * jnp.eye(6 * L) + damping * jnp.eye(6 * L)
        # Gauge: unoptimized/padded cameras get identity rows via mask.
        dc = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(S_m), bs.reshape(-1)).reshape(L, 6)
        dc = jnp.where(jnp.isfinite(dc), dc, 0.0)
        # Keyframe 0 is always held fixed (gauge anchor) — the reference
        # does the same (setFixed(mnId==0)); without it, when every keyframe
        # is local the whole map drifts freely.
        dc = dc * (prob.kf_mask[:L] & (prob.kf_ids[:L] != 0))[:, None]
        # Back-substitution: dp = -Hpp^-1 (bp + W^T dc). The gauge is
        # anchored by the fixed observer keyframes.
        WTdc = jnp.einsum("apij,ai->pj", Wap, dc, precision=_PREC)
        dp = -jnp.einsum("pij,pj->pi", Hpp_inv, bp + WTdc, precision=_PREC)
        dp = jnp.where(jnp.isfinite(dp), dp, 0.0) * prob.pt_mask[:, None]

        new_local = jax.vmap(lambda x, T: lie.se3_exp(x) @ T)(dc, poses[:L])
        cand_poses = jnp.concatenate([new_local, poses[L:]], axis=0)
        cand_pts = pts + dp
        cand_cost = robust_cost(cand_poses, cand_pts, inlier)
        accept = cand_cost < cost
        poses = jnp.where(accept, cand_poses, poses)
        pts = jnp.where(accept, cand_pts, pts)
        cost = jnp.where(accept, cand_cost, cost)
        lam = jnp.clip(jnp.where(accept, lam * 0.33, lam * 8.0), 1e-6, 1e3)
        return (poses, pts, lam, cost)

    # Pass 1: 5 iterations, all edges.
    inlier = jnp.ones_like(prob.obs_slot, bool)
    state = (poses0, pts0, jnp.asarray(1e-4, jnp.float32),
             robust_cost(poses0, pts0, inlier))
    for _ in range(iters1):
        state = gn_iter(state, inlier)
    # Outlier classification (Optimizer.cc: chi2 gate between passes).
    r, _, _, valid, e2, _ = _edge_terms(state[0], state[1], prob, uv, ur,
                                        inv_sigma2, K, bf)
    chi2_th = jnp.where(ur >= 0, CHI2_STEREO, CHI2_MONO)
    inlier = valid & (e2 <= chi2_th)
    state = (state[0], state[1], state[2],
             robust_cost(state[0], state[1], inlier))
    for _ in range(iters2):
        state = gn_iter(state, inlier)
    poses, pts = state[0], state[1]
    # Keep poses on SE(3): repeated exp-compositions preserve (and float
    # rounding seeds) SO(3) deviation that the tracker's velocity cycle then
    # amplifies geometrically (lie.so3_project).
    poses = lie.se3_orthonormalize(poses)
    r, _, _, valid, e2, _ = _edge_terms(poses, pts, prob, uv, ur,
                                        inv_sigma2, K, bf)
    outlier = valid & (e2 > chi2_th)

    # Write back poses and points.
    arena = arena._replace(
        kf_pose=arena.kf_pose.at[jnp.where(prob.kf_mask[:L], prob.kf_ids[:L],
                                           arena.kmax - 1)].set(
            jnp.where(prob.kf_mask[:L, None, None], poses[:L],
                      arena.kf_pose[jnp.where(prob.kf_mask[:L],
                                              prob.kf_ids[:L],
                                              arena.kmax - 1)])),
        pt_pos=arena.pt_pos.at[jnp.where(prob.pt_mask, prob.pt_ids, 0)].set(
            jnp.where(prob.pt_mask[:, None], pts, arena.pt_pos[
                jnp.where(prob.pt_mask, prob.pt_ids, 0)])),
    )
    if cull:
        # Erase outlier observations (Optimizer.cc:941-963).
        kf_rows = jnp.broadcast_to(prob.kf_ids[:, None], prob.obs_slot.shape)
        flat_kf = jnp.where(outlier, kf_rows, arena.kmax - 1).reshape(-1)
        flat_n = jnp.broadcast_to(
            jnp.arange(prob.obs_slot.shape[1])[None], prob.obs_slot.shape
        ).reshape(-1)
        obs_removed = arena.kf_obs.at[(flat_kf, flat_n)].set(
            jnp.where(outlier.reshape(-1), -1,
                      arena.kf_obs[(flat_kf, flat_n)]))
        pt_rows = jnp.where(outlier, arena.kf_obs[(kf_rows.reshape(-1),
                                                   flat_n)].reshape(
            prob.obs_slot.shape), -1)
        dec = jnp.zeros(arena.pmax, jnp.int32).at[
            jnp.where(pt_rows >= 0, pt_rows, 0).reshape(-1)].add(
            (pt_rows >= 0).reshape(-1).astype(jnp.int32))
        arena = arena._replace(kf_obs=obs_removed,
                               pt_n_obs=jnp.maximum(arena.pt_n_obs - dec, 0))
    return arena, jnp.sum(outlier)


def local_bundle_adjustment(arena: ma.MapArena, kf_id, cfg: SlamConfig,
                            iters1: int = 5, iters2: int = 5):
    """Host entry: build the problem and run it (one XLA program each)."""
    prob = build_problem(arena, jnp.asarray(kf_id), cfg)
    return run_local_ba(arena, prob, cfg, iters1, iters2)
