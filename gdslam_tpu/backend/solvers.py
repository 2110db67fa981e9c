"""Closed-form alignment solvers + vmapped RANSAC.

Replaces the reference's sampling solvers with vmapped hypothesis
batteries:

- `horn_alignment`: Horn's absolute-orientation closed form (SVD) for
  SE3 (fixed scale) or Sim3 — the math behind Sim3Solver::ComputeSim3
  (reference Sim3Solver.h:55-58; scale fixed for RGB-D per Sim3Solver.h:20).
- `ransac_rigid`: RANSAC over 3D-3D correspondences. This also serves where
  the reference uses EPnP RANSAC (PnPsolver, Tracking.cc:1715) and
  solvePnPRansac (GeoMaskMaker.cc:149-150): with RGB-D, every keypoint has
  depth, so relative pose is a 3D-3D problem with a closed-form minimal
  solver — all `n_iters` hypotheses are solved and scored in parallel with
  one vmap instead of a sequential early-exit loop.

Consensus is scored by *reprojection* error in the target view (matching the
reference's image-space inlier checks).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gdslam_tpu.core import lie

_PREC = jax.lax.Precision.HIGHEST


def horn_alignment(P: jnp.ndarray, Q: jnp.ndarray, w: jnp.ndarray,
                   with_scale: bool = False):
    """Weighted closed-form R, t, s with s*R @ P + t ~= Q.

    P, Q: [n, 3]; w: [n] non-negative weights (0 = ignore).
    Returns (R [3,3], t [3], s scalar). Supports leading batch dims via vmap.
    """
    wsum = jnp.sum(w) + 1e-12
    cp = jnp.einsum("n,ni->i", w, P, precision=_PREC) / wsum
    cq = jnp.einsum("n,ni->i", w, Q, precision=_PREC) / wsum
    Pc = P - cp
    Qc = Q - cq
    H = jnp.einsum("n,ni,nj->ij", w, Pc, Qc, precision=_PREC)
    U, S, Vt = jnp.linalg.svd(H)
    d = jnp.linalg.det(Vt.T @ U.T)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0]) * jnp.stack([1.0, 1.0, d]))
    R = Vt.T @ D @ U.T
    if with_scale:
        num = jnp.einsum("n,ni,ni->", w, Qc, jnp.einsum("ij,nj->ni", R, Pc, precision=_PREC),
                         precision=_PREC)
        den = jnp.einsum("n,ni,ni->", w, Pc, Pc, precision=_PREC) + 1e-12
        s = num / den
    else:
        s = jnp.asarray(1.0)
    t = cq - s * (R @ cp)
    return R, t, s


class RansacResult(NamedTuple):
    T: jnp.ndarray          # [4, 4] best rigid transform (Q <- P)
    inliers: jnp.ndarray    # [n] bool consensus set
    n_inliers: jnp.ndarray  # scalar int
    ok: jnp.ndarray         # scalar bool (enough inliers found)


@partial(jax.jit, static_argnums=(4, 6, 7, 8))
def ransac_rigid(P: jnp.ndarray, Q: jnp.ndarray, valid: jnp.ndarray,
                 key: jnp.ndarray, K: tuple, uv_q: jnp.ndarray,
                 n_iters: int = 300, sample_size: int = 3,
                 min_inliers: int = 10, px_threshold: float = 4.0) -> RansacResult:
    """RANSAC rigid 3D-3D with reprojection consensus.

    P [n,3] source points, Q [n,3] target-frame points, uv_q [n,2] observed
    pixels in the target view; K = (fx, fy, cx, cy). All hypotheses are
    evaluated in parallel (n_iters fixed, no early exit — the reference caps
    at 300 iterations anyway, SetRansacParameters Tracking.cc:1715).
    """
    n = P.shape[0]
    fx, fy, cx, cy = K
    probs = valid.astype(jnp.float32) / jnp.maximum(jnp.sum(valid), 1)
    # Sample with replacement; degenerate (repeated-index) samples simply
    # yield poor hypotheses that lose the argmax.
    idx = jax.random.categorical(
        key, jnp.log(probs + 1e-12)[None, :].repeat(n_iters * sample_size, 0))
    idx = idx.reshape(n_iters, sample_size)

    def solve_one(sample_idx):
        Ps = P[sample_idx]
        Qs = Q[sample_idx]
        R, t, _ = horn_alignment(Ps, Qs, jnp.ones(sample_size))
        return lie.rt_to_mat(R, t)

    Ts = jax.vmap(solve_one)(idx)                       # [iters, 4, 4]

    def score_one(T):
        Pq = lie.se3_apply(T, P)                        # [n, 3]
        z = jnp.maximum(Pq[:, 2], 1e-6)
        u = fx * Pq[:, 0] / z + cx
        v = fy * Pq[:, 1] / z + cy
        err = jnp.hypot(u - uv_q[:, 0], v - uv_q[:, 1])
        inl = valid & (err < px_threshold) & (Pq[:, 2] > 1e-6)
        return jnp.sum(inl), inl

    scores, inls = jax.vmap(score_one)(Ts)
    best = jnp.argmax(scores)
    inliers = inls[best]

    # Refine on the full consensus set (closed form again).
    R, t, _ = horn_alignment(P, Q, inliers.astype(jnp.float32))
    T_ref = lie.rt_to_mat(R, t)
    n_ref, inliers_ref = score_one(T_ref)
    use_ref = n_ref >= scores[best]
    T_best = jnp.where(use_ref, T_ref, Ts[best])
    inliers = jnp.where(use_ref, inliers_ref, inliers)
    n_best = jnp.maximum(n_ref, scores[best])
    return RansacResult(T=T_best, inliers=inliers, n_inliers=n_best,
                        ok=n_best >= min_inliers)


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def ransac_pnp(pw: jnp.ndarray, uv: jnp.ndarray, valid: jnp.ndarray,
               K: tuple, n_iters: int = 300, min_inliers: int = 10,
               px_threshold: float = 2.45, key=None):
    """2D-3D pose RANSAC — the PnPsolver/EPnP role (reference PnPsolver.h:73,
    SetRansacParameters(0.99, 10, 300, 4, 0.5, 5.991) at Tracking.cc:1715)
    for observations WITHOUT depth (monocular relocalization).

    Minimal solver: 6-point DLT for the projection matrix with known K,
    R orthonormalized by SVD — all hypotheses vmapped; consensus by
    reprojection (threshold ~ sqrt(5.991) px). Returns RansacResult.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    fx, fy, cx, cy = K
    n = pw.shape[0]
    # normalized image coords
    xn = jnp.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], 1)
    probs = valid.astype(jnp.float32) / jnp.maximum(jnp.sum(valid), 1)
    idx = jax.random.categorical(
        key, jnp.log(probs + 1e-12)[None].repeat(n_iters * 6, 0)
    ).reshape(n_iters, 6)

    def _P_to_T(P, Xh, w):
        """Projection matrix -> SE3, resolving the projective sign on the
        RAW 3x4 matrix first (flipping an orthonormalized R negates it,
        which is NOT a rotation): weighted projective depths of the support
        set must be positive."""
        w_depth = (Xh @ P[2]) * w
        P = jnp.where(jnp.sum(w_depth) < 0, -P, P)
        Rraw = P[:, :3]
        U, S, Vt2 = jnp.linalg.svd(Rraw)
        d = jnp.linalg.det(U @ Vt2)
        R = U @ jnp.diag(jnp.stack([1.0, 1.0, d])) @ Vt2
        scale = jnp.sum(S) / 3.0
        t = P[:, 3] / jnp.maximum(scale, 1e-12)
        return lie.rt_to_mat(R, t)

    def solve_one(si):
        X = pw[si]
        x = xn[si]
        rows = []
        for i in range(6):
            Xi = jnp.concatenate([X[i], jnp.ones(1)])
            z4 = jnp.zeros(4)
            rows.append(jnp.concatenate([Xi, z4, -x[i, 0] * Xi]))
            rows.append(jnp.concatenate([z4, Xi, -x[i, 1] * Xi]))
        A = jnp.stack(rows)
        _, _, Vt = jnp.linalg.svd(A)
        P = Vt[-1].reshape(3, 4)
        Xh = jnp.concatenate([X, jnp.ones((X.shape[0], 1))], axis=1)
        return _P_to_T(P, Xh, jnp.ones(X.shape[0]))

    Ts = jax.vmap(solve_one)(idx)

    def score_one(T):
        Pq = lie.se3_apply(T, pw)
        z = jnp.maximum(Pq[:, 2], 1e-6)
        u = fx * Pq[:, 0] / z + cx
        v = fy * Pq[:, 1] / z + cy
        err = jnp.hypot(u - uv[:, 0], v - uv[:, 1])
        inl = valid & (err < px_threshold) & (Pq[:, 2] > 1e-6)
        return jnp.sum(inl), inl

    scores, inls = jax.vmap(score_one)(Ts)
    best = jnp.argmax(scores)
    T_best, inl_best = Ts[best], inls[best]

    # Local optimization (the "refine" stage of PnPsolver::Refine,
    # PnPsolver.cc:437-471): refit a weighted DLT on the FULL consensus set
    # and rescore, twice. A minimal 6-point sample under pixel noise gives a
    # coarse pose that undercounts inliers badly; one refit typically grows
    # the consensus to the full inlier set.
    Xh_all = jnp.concatenate([pw, jnp.ones((n, 1))], axis=1)
    z4_all = jnp.zeros((n, 4))
    r1 = jnp.concatenate([Xh_all, z4_all, -xn[:, 0:1] * Xh_all], axis=1)
    r2 = jnp.concatenate([z4_all, Xh_all, -xn[:, 1:2] * Xh_all], axis=1)

    def refit(carry, _):
        T, inl = carry
        w = inl.astype(jnp.float32)
        # guard: keep the previous pose when the support is too thin
        enough = jnp.sum(w) >= 6
        A = jnp.concatenate([r1 * w[:, None], r2 * w[:, None]], axis=0)
        _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
        T_new = _P_to_T(Vt[-1].reshape(3, 4), Xh_all, w)
        n_new, inl_new = score_one(T_new)
        better = enough & (n_new >= jnp.sum(inl))
        T = jnp.where(better, T_new, T)
        inl = jnp.where(better, inl_new, inl)
        return (T, inl), None

    (T_best, inl_best), _ = jax.lax.scan(refit, (T_best, inl_best),
                                         None, length=2)
    n_best = jnp.sum(inl_best)
    return RansacResult(T=T_best, inliers=inl_best,
                        n_inliers=n_best,
                        ok=n_best >= min_inliers)


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def ransac_sim3(P: jnp.ndarray, Q: jnp.ndarray, valid: jnp.ndarray,
                key: jnp.ndarray, n_iters: int = 300, min_inliers: int = 20,
                err_threshold: float = 0.05, with_scale: bool = False,
                uv_p: jnp.ndarray = None, uv_q: jnp.ndarray = None,
                K: tuple = None, px_threshold=3.04):
    """RANSAC Sim3/SE3 on 3D-3D — Sim3Solver::iterate semantics
    (RANSAC(0.99, 20, 300), LoopClosing.cc:279). Scale is fixed at 1 for
    RGB-D unless with_scale.

    Consensus: metric (|S P - Q| < err_threshold) by default; when
    uv_p/uv_q/K are given, BIDIRECTIONAL REPROJECTION in pixels instead
    (Sim3Solver::CheckInliers, Sim3Solver.cc:180-209: project S P into the
    current image against uv_q and S^-1 Q into the candidate image against
    uv_p; px_threshold ~ sqrt(9.21), scalar or per-point [N] — the
    reference scales it by the keypoint octave's sigma, Sim3Solver.cc:66
    mvnMaxError). Reprojection consensus is gauge-free — required for
    monocular maps, whose metric scale is arbitrary."""
    n = P.shape[0]
    probs = valid.astype(jnp.float32) / jnp.maximum(jnp.sum(valid), 1)
    idx = jax.random.categorical(
        key, jnp.log(probs + 1e-12)[None, :].repeat(n_iters * 3, 0)).reshape(n_iters, 3)

    def solve_one(si):
        R, t, s = horn_alignment(P[si], Q[si], jnp.ones(3), with_scale=with_scale)
        return R, t, s

    Rs, ts, ss = jax.vmap(solve_one)(idx)

    if uv_p is not None:
        fx, fy, cx, cy = K

        def _reproj_err(Xc, uv):
            z = jnp.maximum(Xc[..., 2], 1e-6)
            u = fx * Xc[..., 0] / z + cx
            v = fy * Xc[..., 1] / z + cy
            return jnp.hypot(u - uv[..., 0], v - uv[..., 1]), Xc[..., 2] > 0

        def score_one(R, t, s):
            eq, zq = _reproj_err(lie.sim3_apply(R, t, s, P), uv_q)
            Ri, ti, si = lie.sim3_inverse(R, t, s)
            ep, zp = _reproj_err(lie.sim3_apply(Ri, ti, si, Q), uv_p)
            inl = valid & zq & zp & (eq < px_threshold) & (ep < px_threshold)
            return jnp.sum(inl), inl
    else:
        def score_one(R, t, s):
            Pq = lie.sim3_apply(R, t, s, P)
            err = jnp.linalg.norm(Pq - Q, axis=-1)
            inl = valid & (err < err_threshold)
            return jnp.sum(inl), inl

    scores, inls = jax.vmap(score_one)(Rs, ts, ss)
    best = jnp.argmax(scores)
    w = inls[best].astype(jnp.float32)
    R, t, s = horn_alignment(P, Q, w, with_scale=with_scale)
    n_fin, inl_fin = score_one(R, t, s)
    return R, t, s, inl_fin, n_fin, n_fin >= min_inliers


@partial(jax.jit, static_argnums=(9, 10))
def optimize_sim3(X1, X2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid,
                  S12_init, K, with_scale: bool = False, th2: float = 10.0):
    """Gauss-Newton Sim3 refinement on bidirectional reprojection residuals
    — Optimizer::OptimizeSim3 (reference Optimizer.cc:1262-1391) semantics.

    X1/X2: [N, 3] matched 3D points in KF1/KF2 camera coords; uv1/uv2 their
    observed keypoints in the respective images; S12_init = (R, t, s) maps
    cam2 coords into cam1 (the RANSAC hypothesis). Edge pair per match
    (Optimizer.cc:1300-1345): e12 = uv1 - proj(S12 X2) and
    e21 = uv2 - proj(S12^-1 X1), Huber, chi2 cull at th2=10 per direction
    after the first round (cc:1350-1365), second round on survivors, final
    inlier = both directions under th2.

    Returns (R, t, s, inliers [N] bool, n_inliers). Design: one fused
    GN program, jacfwd over the 7-vector tangent (scale column zeroed when
    with_scale=False), fixed 2x5 iterations — no per-edge host loop."""
    fx, fy, cx, cy = K
    delta = jnp.sqrt(th2)
    R0, t0, s0 = S12_init
    n = X1.shape[0]

    def proj(Xc):
        z = jnp.maximum(Xc[..., 2], 1e-6)
        return jnp.stack([fx * Xc[..., 0] / z + cx,
                          fy * Xc[..., 1] / z + cy], axis=-1)

    def residuals(xi, R, t, s):
        # left-multiplicative tangent update: S = exp(xi) o S
        dR, dt, ds = lie.sim3_exp(xi)
        Rn, tn, sn = lie.sim3_compose(dR, dt, ds, R, t, s)
        X2_in1 = lie.sim3_apply(Rn, tn, sn, X2)
        Ri, ti, si = lie.sim3_inverse(Rn, tn, sn)
        X1_in2 = lie.sim3_apply(Ri, ti, si, X1)
        r12 = (uv1 - proj(X2_in1)) * jnp.sqrt(inv_sigma2_1)[:, None]
        r21 = (uv2 - proj(X1_in2)) * jnp.sqrt(inv_sigma2_2)[:, None]
        return r12, r21

    def chi2_pair(R, t, s):
        r12, r21 = residuals(jnp.zeros(7), R, t, s)
        return jnp.sum(r12 * r12, -1), jnp.sum(r21 * r21, -1)

    def gn_round(R, t, s, active, n_iters):
        def body(_, carry):
            R, t, s = carry

            def flat(xi):
                r12, r21 = residuals(xi, R, t, s)
                return jnp.concatenate([r12, r21], axis=0)   # [2N, 2]

            r = flat(jnp.zeros(7))
            J = jax.jacfwd(flat)(jnp.zeros(7))               # [2N, 2, 7]
            if not with_scale:
                J = J.at[..., 6].set(0.0)
            # Huber weights per edge (per direction), shared over u/v
            chi = jnp.sum(r * r, axis=-1)
            w_h = jnp.where(chi <= th2, 1.0,
                            delta / jnp.sqrt(jnp.maximum(chi, 1e-12)))
            w = w_h * jnp.concatenate([active, active]).astype(jnp.float32)
            JW = J * w[:, None, None]
            H = jnp.einsum("nri,nrj->ij", JW, J, precision=_PREC)
            g = jnp.einsum("nri,nr->i", JW, r, precision=_PREC)
            H = H + 1e-6 * jnp.eye(7)
            if not with_scale:
                H = H.at[6, 6].set(1.0)
            xi = -jnp.linalg.solve(H, g)
            dR, dt, ds = lie.sim3_exp(xi)
            return lie.sim3_compose(dR, dt, ds, R, t, s)

        return jax.lax.fori_loop(0, n_iters, body, (R, t, s))

    active = valid
    R1, t1, s1 = gn_round(R0, t0, s0, active, 5)
    c12, c21 = chi2_pair(R1, t1, s1)
    active = valid & (c12 <= th2) & (c21 <= th2)
    R2, t2, s2 = gn_round(R1, t1, s1, active, 5)
    c12, c21 = chi2_pair(R2, t2, s2)
    inl = valid & (c12 <= th2) & (c21 <= th2)
    return R2, t2, s2, inl, jnp.sum(inl)
