"""Monocular two-view initialization: H vs F model selection + reconstruction.

Replaces the reference Initializer (include/Initializer.h:42-72,
src/Initializer.cc): RANSAC homography (4-pt DLT) and fundamental (8-pt)
hypotheses scored in parallel, model selection by score ratio RH > 0.45,
then pose recovery — E = K^T F K decomposition into 4 (R, t) candidates (or
the homography's planar decomposition, here covered by the same E path),
selected by cheirality vote of triangulated points.

Design: all RANSAC hypotheses are vmapped SVD batteries — no sequential
iteration; triangulation is a closed-form batched DLT.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gdslam_tpu.core import lie

_PREC = jax.lax.Precision.HIGHEST


def triangulate(P1: jnp.ndarray, P2: jnp.ndarray, x1: jnp.ndarray,
                x2: jnp.ndarray) -> jnp.ndarray:
    """Batched 2-view DLT triangulation.

    P1, P2: [3, 4] projection matrices; x1, x2: [N, 2] pixel coords.
    Returns [N, 3] world points (Initializer::Triangulate semantics).
    """
    def one(a, b):
        A = jnp.stack([
            a[0] * P1[2] - P1[0],
            a[1] * P1[2] - P1[1],
            b[0] * P2[2] - P2[0],
            b[1] * P2[2] - P2[1],
        ])
        _, _, Vt = jnp.linalg.svd(A)
        X = Vt[-1]
        return X[:3] / jnp.where(jnp.abs(X[3]) > 1e-12, X[3], 1e-12)

    return jax.vmap(one)(x1, x2)


def _normalize(pts: jnp.ndarray, w) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Hartley normalization with weights (for conditioning)."""
    wsum = jnp.sum(w) + 1e-9
    mean = jnp.einsum("n,ni->i", w, pts) / wsum
    d = jnp.einsum("n,n->", w, jnp.linalg.norm(pts - mean, axis=1)) / wsum
    s = jnp.sqrt(2.0) / jnp.maximum(d, 1e-9)
    T = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    T = T.at[0, 0].set(s).at[1, 1].set(s).at[0, 2].set(-s * mean[0]).at[1, 2].set(-s * mean[1])
    return (pts - mean) * s, T


def _fundamental_8pt(x1, x2):
    """8-point F from [8, 2] correspondences (already conditioned)."""
    A = jnp.stack([
        x2[:, 0] * x1[:, 0], x2[:, 0] * x1[:, 1], x2[:, 0],
        x2[:, 1] * x1[:, 0], x2[:, 1] * x1[:, 1], x2[:, 1],
        x1[:, 0], x1[:, 1], jnp.ones(x1.shape[0]),
    ], axis=1)
    _, _, Vt = jnp.linalg.svd(A)
    F = Vt[-1].reshape(3, 3)
    U, S, Vt2 = jnp.linalg.svd(F)
    return (U * jnp.stack([S[0], S[1], 0.0])) @ Vt2   # rank-2 enforcement


def _homography_4pt(x1, x2):
    """4-point DLT homography from [4, 2] correspondences."""
    def rows(a, b):
        return jnp.stack([
            jnp.concatenate([a, jnp.ones(1), jnp.zeros(3),
                             -b[0] * a, -b[0:1]]),
            jnp.concatenate([jnp.zeros(3), a, jnp.ones(1),
                             -b[1] * a, -b[1:2]]),
        ])
    A = jnp.concatenate([rows(x1[i], x2[i]) for i in range(4)], axis=0)
    _, _, Vt = jnp.linalg.svd(A)
    return Vt[-1].reshape(3, 3)


class InitResult(NamedTuple):
    ok: jnp.ndarray
    T_21: jnp.ndarray         # [4, 4] pose of view 2 w.r.t. view 1
    points: jnp.ndarray       # [N, 3] triangulated (view-1 frame)
    is_good: jnp.ndarray      # [N] bool triangulation validity
    used_homography: jnp.ndarray


@partial(jax.jit, static_argnums=(4, 5))
def initialize(x1: jnp.ndarray, x2: jnp.ndarray, valid: jnp.ndarray,
               key: jnp.ndarray, K: tuple, n_iters: int = 200) -> InitResult:
    """Two-view bootstrap from matched pixel coords x1 <-> x2 [N, 2]."""
    fx, fy, cx, cy = K
    Km = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    K_inv = jnp.linalg.inv(Km)
    n = x1.shape[0]
    probs = valid / jnp.maximum(jnp.sum(valid), 1)
    logp = jnp.log(probs + 1e-12)

    # --- Fundamental RANSAC (8-point, Hartley-normalized) ---
    w = valid.astype(jnp.float32)
    x1n, T1 = _normalize(x1, w)
    x2n, T2 = _normalize(x2, w)
    idx_f = jax.random.categorical(
        key, logp[None].repeat(n_iters * 8, 0)).reshape(n_iters, 8)

    def solve_f(si):
        Fn = _fundamental_8pt(x1n[si], x2n[si])
        return T2.T @ Fn @ T1

    Fs = jax.vmap(solve_f)(idx_f)

    def score_f(F):
        # symmetric epipolar distance, chi2-capped (Initializer CheckFundamental)
        l2 = jnp.einsum("ij,nj->ni", F, jnp.concatenate(
            [x1, jnp.ones((n, 1))], 1), precision=_PREC)
        l1 = jnp.einsum("ji,nj->ni", F, jnp.concatenate(
            [x2, jnp.ones((n, 1))], 1), precision=_PREC)
        d2 = (jnp.einsum("ni,ni->n", jnp.concatenate([x2, jnp.ones((n, 1))], 1), l2)
              ** 2) / jnp.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12)
        d1 = (jnp.einsum("ni,ni->n", jnp.concatenate([x1, jnp.ones((n, 1))], 1), l1)
              ** 2) / jnp.maximum(l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12)
        th = 3.841
        sc = jnp.where(valid & (d1 < th), 5.991 - d1, 0.0) + \
            jnp.where(valid & (d2 < th), 5.991 - d2, 0.0)
        inl = valid & (d1 < th) & (d2 < th)
        return jnp.sum(sc), inl

    sf, inl_f = jax.vmap(score_f)(Fs)
    best_f = jnp.argmax(sf)
    F = Fs[best_f]
    inliers = inl_f[best_f]

    # --- Homography RANSAC (4-point) for model selection ---
    idx_h = jax.random.categorical(
        jax.random.fold_in(key, 1), logp[None].repeat(n_iters * 4, 0)
    ).reshape(n_iters, 4)

    T2_inv = jnp.linalg.inv(T2)

    def solve_h(si):
        Hn = _homography_4pt(x1n[si], x2n[si])
        return T2_inv @ Hn @ T1

    Hs = jax.vmap(solve_h)(idx_h)

    def score_h(H):
        x1h = jnp.concatenate([x1, jnp.ones((n, 1))], 1)
        p2 = jnp.einsum("ij,nj->ni", H, x1h, precision=_PREC)
        p2 = p2[:, :2] / jnp.where(jnp.abs(p2[:, 2:]) > 1e-9, p2[:, 2:], 1e-9)
        Hi = jnp.linalg.inv(H)
        x2h = jnp.concatenate([x2, jnp.ones((n, 1))], 1)
        p1 = jnp.einsum("ij,nj->ni", Hi, x2h, precision=_PREC)
        p1 = p1[:, :2] / jnp.where(jnp.abs(p1[:, 2:]) > 1e-9, p1[:, 2:], 1e-9)
        d2 = jnp.sum((p2 - x2) ** 2, 1)
        d1 = jnp.sum((p1 - x1) ** 2, 1)
        th = 5.991
        sc = jnp.where(valid & (d1 < th), th - d1, 0.0) + \
            jnp.where(valid & (d2 < th), th - d2, 0.0)
        return jnp.sum(sc)

    sh = jax.vmap(score_h)(Hs)
    # RH = SH / (SH + SF) > 0.45 selects homography (Initializer.cc:~100);
    # both routes recover pose through E here (planar scenes also admit E
    # except pure-rotation, which correctly fails the cheirality vote).
    rh = jnp.max(sh) / jnp.maximum(jnp.max(sh) + jnp.max(sf), 1e-9)

    # --- pose recovery from E = K^T F K ---
    E = Km.T @ F @ Km
    U, S, Vt = jnp.linalg.svd(E)
    # enforce det(U)=det(V)=1
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.asarray([[0.0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    def build_T(R, tv):
        return lie.rt_to_mat(R, tv)

    cands = jnp.stack([build_T(R1, t), build_T(R1, -t),
                       build_T(R2, t), build_T(R2, -t)])

    P1 = Km @ jnp.eye(4)[:3]

    def vote(T21):
        P2 = Km @ T21[:3]
        X = triangulate(P1, P2, x1, x2)
        z1 = X[:, 2]
        Xc2 = lie.se3_apply(T21, X)
        z2 = Xc2[:, 2]
        good = inliers & (z1 > 0) & (z2 > 0) & (jnp.abs(z1) < 1e4)
        return jnp.sum(good), X, good

    votes, Xs, goods = jax.vmap(vote)(cands)
    best = jnp.argmax(votes)
    n_good = votes[best]
    ok = (n_good > 50) & (n_good > 0.7 * jnp.sum(inliers))

    # Resection-intersection refinement: the E-decomposed translation
    # direction is noisy at narrow baselines; alternate triangulation with
    # a mono pose GN of view 2 (the role of the full BA ORB-SLAM runs after
    # CreateInitialMapMonocular).
    from gdslam_tpu.backend import optimizer as opt
    T21 = cands[best]
    good = goods[best]
    X = Xs[best]
    for _ in range(3):
        obs = opt.PoseObs(pw=jnp.where(good[:, None], X, 0.0), uv=x2,
                          ur=-jnp.ones(n), inv_sigma2=jnp.ones(n),
                          valid=good)
        T21, inl2, _ = opt.pose_optimization(T21, obs, K, 0.0,
                                             rounds=1, iters=8)
        P2 = Km @ T21[:3]
        X = triangulate(P1, P2, x1, x2)
        z2 = lie.se3_apply(T21, X)[:, 2]
        good = inliers & (X[:, 2] > 0) & (z2 > 0) & (jnp.abs(X[:, 2]) < 1e4)
    # keep unit-norm translation convention (mono scale is free)
    tnorm = jnp.linalg.norm(T21[:3, 3])
    T21 = T21.at[:3, 3].multiply(1.0 / jnp.maximum(tnorm, 1e-9))
    X = X / jnp.maximum(tnorm, 1e-9)
    return InitResult(ok=ok, T_21=T21, points=X,
                      is_good=good, used_homography=rh > 0.45)
