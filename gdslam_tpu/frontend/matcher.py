"""Dense projection-guided descriptor matching.

Replaces ORBmatcher's grid-windowed searches (reference ORBmatcher.cc:
SearchByProjection map->frame :45, frame->frame motion model :1328,
relocalization :1472) with one fused dense program: project M candidate
points, build an [M, N] Hamming matrix with an int8 matmul, mask it by
pixel radius / scale window / frustum, and take per-keypoint argmin. At
M=4096, N=1500 this is a ~1.6 GMAC int8 matmul (its time on the H100 is in
PERF.md), so the CPU-oriented grid indirection (Frame.cc:402-417,
GetFeaturesInArea) is unnecessary.

Thresholds follow ORBmatcher.cc:37-39: TH_HIGH=100, TH_LOW=50,
HISTO_LENGTH=30 (rotation-consistency histogram, top-3 bins kept).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gdslam_tpu.core import lie
from gdslam_tpu.ops import hamming, orb

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
# numpy (host) constant: an eager jnp constant would be captured as a
# device-array jaxpr const and hoisted into a hidden executable parameter,
# which the C++ jit fastpath drops on replay (see backend/mapping.py).
_BIG = np.int32(1 << 20)


class MatchResult(NamedTuple):
    point_idx: jnp.ndarray   # [N] int32 candidate row matched per keypoint (-1)
    distance: jnp.ndarray    # [N] int32 Hamming distance (valid rows only)
    n_matches: jnp.ndarray   # scalar int32


def rotation_consistency(dangle: jnp.ndarray, matched: jnp.ndarray) -> jnp.ndarray:
    """Keep only matches whose angle difference falls in the 3 dominant
    30-bin histogram bins (ORBmatcher::ComputeThreeMaxima, cc:1601)."""
    frac = jnp.mod(dangle, 2 * jnp.pi) / (2 * jnp.pi)
    bins = jnp.clip((frac * HISTO_LENGTH).astype(jnp.int32), 0, HISTO_LENGTH - 1)
    hist = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bins].add(matched.astype(jnp.int32))
    top3 = jax.lax.top_k(hist, 3)[0]
    # match reference rule: drop bins below 0.1x the max bin
    keep_bin = (hist >= top3[2]) & (hist.astype(jnp.float32) >
                                    0.1 * top3[0].astype(jnp.float32))
    return matched & keep_bin[bins]


def match_candidates(cand_uv: jnp.ndarray, cand_valid: jnp.ndarray,
                     cand_desc_pm1: jnp.ndarray, cand_level: jnp.ndarray,
                     cand_angle: jnp.ndarray, cand_radius: jnp.ndarray,
                     kp_uv: jnp.ndarray, kp_valid: jnp.ndarray,
                     kp_desc_pm1: jnp.ndarray, kp_level: jnp.ndarray,
                     kp_angle: jnp.ndarray,
                     th_hamming: int = TH_HIGH, level_slack: int = 1,
                     use_rotation: bool = True,
                     nn_ratio: float = 1.0) -> MatchResult:
    """Core dense matcher.

    cand_*: M projected candidates (expected pixel position, search radius,
    predicted level). kp_*: N frame keypoints. Returns per-keypoint best
    candidate row subject to radius/level/Hamming gates, with one-to-one
    enforcement (each candidate keeps only its best keypoint).
    """
    M, N = cand_uv.shape[0], kp_uv.shape[0]
    ham = hamming.hamming_matrix(cand_desc_pm1, kp_desc_pm1)      # [M, N]
    du = cand_uv[:, None, 0] - kp_uv[None, :, 0]
    dv = cand_uv[:, None, 1] - kp_uv[None, :, 1]
    within = (du * du + dv * dv) <= (cand_radius * cand_radius)[:, None]
    lvl_ok = jnp.abs(cand_level[:, None] - kp_level[None, :]) <= level_slack
    mask = within & lvl_ok & cand_valid[:, None] & kp_valid[None, :]
    cost = jnp.where(mask, ham, _BIG)

    # Per-keypoint best candidate (+ ratio test against 2nd best if requested)
    best_kp, second_kp, arg_kp = hamming.best_two(cost, axis=0)    # over M
    good = (best_kp <= th_hamming)
    if nn_ratio < 1.0:
        good = good & (best_kp.astype(jnp.float32)
                       < nn_ratio * jnp.minimum(second_kp, _BIG).astype(jnp.float32))

    # One-to-one: candidate row keeps only its best keypoint.
    best_cand = jnp.min(cost, axis=1)                              # [M]
    kp_cost = jnp.take_along_axis(cost, arg_kp[None, :], axis=0)[0]  # cost of chosen pair
    is_cand_best = kp_cost <= best_cand[arg_kp]
    good = good & is_cand_best

    if use_rotation:
        dangle = kp_angle - cand_angle[arg_kp]
        good = good & rotation_consistency(dangle, good)

    point_idx = jnp.where(good, arg_kp, -1)
    return MatchResult(point_idx=point_idx.astype(jnp.int32),
                       distance=jnp.where(good, kp_cost, _BIG).astype(jnp.int32),
                       n_matches=jnp.sum(good))


def project_for_search(pt_pos: jnp.ndarray, pt_valid: jnp.ndarray,
                       T_cw: jnp.ndarray, K: tuple, image_wh: tuple,
                       scale_factors: jnp.ndarray,
                       pt_max_dist: jnp.ndarray | None = None,
                       pt_normal: jnp.ndarray | None = None,
                       base_radius: float = 4.0):
    """Project world points and derive search windows.

    Implements the Frame::isInFrustum gates (Frame.cc:441-497): positive
    depth, in-image, distance within [0.8 min, 1.2 max] scale range, viewing
    angle cos > 0.5, and predicted octave from distance
    (MapPoint::PredictScale, MapPoint.cc:385-420). Radius scales with the
    predicted level and with viewing angle (ORBmatcher::RadiusByViewingCos).
    Returns (uv [M,2], level [M] int32, radius [M], valid [M]).
    """
    fx, fy, cx, cy = K
    W, H = image_wh
    Xc = lie.se3_apply(T_cw, pt_pos)
    z = Xc[:, 2]
    z_ok = z > 1e-6
    zs = jnp.where(z_ok, z, 1.0)
    u = fx * Xc[:, 0] / zs + cx
    v = fy * Xc[:, 1] / zs + cy
    in_img = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    valid = pt_valid & z_ok & in_img

    n_levels = scale_factors.shape[0]
    if pt_max_dist is not None:
        # camera center in world: -R^T t
        Rcw = T_cw[:3, :3]
        ow = -Rcw.T @ T_cw[:3, 3]
        po = pt_pos - ow
        dist = jnp.linalg.norm(po, axis=1)
        valid = valid & (dist >= 0.8 * pt_max_dist / scale_factors[-1]) \
                      & (dist <= 1.2 * pt_max_dist)
        ratio = pt_max_dist / jnp.maximum(dist, 1e-6)
        level = jnp.clip(jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-6))
                                  / jnp.log(scale_factors[1])), 0, n_levels - 1
                         ).astype(jnp.int32)
        if pt_normal is not None:
            view_cos = jnp.einsum("ni,ni->n", po, pt_normal) / jnp.maximum(dist, 1e-6)
            valid = valid & (view_cos > 0.5)
            radius_factor = jnp.where(view_cos > 0.998, 2.5, 4.0)
        else:
            radius_factor = jnp.full_like(dist, 4.0)
    else:
        level = jnp.zeros(pt_pos.shape[0], jnp.int32)
        radius_factor = jnp.full(pt_pos.shape[0], base_radius)

    radius = radius_factor * scale_factors[level] * (base_radius / 4.0)
    return jnp.stack([u, v], 1), level, radius, valid
