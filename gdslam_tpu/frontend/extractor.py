"""ORB feature extractor: pyramid -> FAST -> distribution -> angle -> rBRIEF.

Re-design of the reference ORBextractor::operator() pipeline
(ORBextractor.cc:1043-1105):
- ComputePyramid (1107-1132)        -> ops.image.build_pyramid (one [L,H,W]
  canvas, static shapes)
- ComputeKeyPointsOctTree (765-853) -> dense FAST score maps (threshold 20,
  per-cell fallback 7), 3x3 NMS, per-cell top-2 + per-level top-quota
  selection. This replaces DistributeOctTree (539-763): the quadtree's
  "split until #nodes >= N, keep best per node" is approximated by best-2 per
  16px cell, which keeps the same spatial-spread property with static shapes.
- IC angle + GaussianBlur(7,2) + rBRIEF (1085-1086, 77-147) -> ops.orb.

Everything is one jitted program per frame; output is a fixed-size padded
`Features` pytree (N = n_features, invalid entries masked).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gdslam_tpu.config import OrbConfig
from gdslam_tpu.ops import fast as fast_ops
from gdslam_tpu.ops import image as image_ops
from gdslam_tpu.ops import orb as orb_ops

EDGE_MARGIN = 16      # reference detects within minBorder=19-3 (ORBextractor.cc:774)
CELL = 16             # candidate cell size (px), top-2 kept per cell


class Features(NamedTuple):
    """Fixed-size padded feature set for one image."""

    uv: jnp.ndarray        # [N, 2] float32, level-0 pixel coords (distorted)
    response: jnp.ndarray  # [N] float32 FAST score (0 => invalid)
    angle: jnp.ndarray     # [N] float32 radians
    level: jnp.ndarray     # [N] int32 pyramid octave
    desc: jnp.ndarray      # [N, 32] uint8 packed rBRIEF
    valid: jnp.ndarray     # [N] bool

    @property
    def n(self) -> int:
        return self.uv.shape[0]


def _level_candidates(score: jnp.ndarray, h: int, w: int):
    """Per-cell top-2 candidates from a score map. Returns (scores, uv)."""
    H, W = score.shape
    # Zero outside the valid detection region of this level.
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    ok = (ys >= EDGE_MARGIN) & (ys < h - EDGE_MARGIN) & \
         (xs >= EDGE_MARGIN) & (xs < w - EDGE_MARGIN)
    score = jnp.where(ok, score, 0.0)

    Hc, Wc = H // CELL, W // CELL
    cells = score[:Hc * CELL, :Wc * CELL].reshape(Hc, CELL, Wc, CELL)
    cells = cells.transpose(0, 2, 1, 3).reshape(Hc, Wc, CELL * CELL)
    vals, idx = jax.lax.top_k(cells, 2)              # [Hc, Wc, 2]
    in_y = idx // CELL
    in_x = idx % CELL
    cy = jax.lax.broadcasted_iota(jnp.int32, (Hc, Wc, 2), 0)
    cx = jax.lax.broadcasted_iota(jnp.int32, (Hc, Wc, 2), 1)
    u = (cx * CELL + in_x).reshape(-1).astype(jnp.float32)
    v = (cy * CELL + in_y).reshape(-1).astype(jnp.float32)
    return vals.reshape(-1), jnp.stack([u, v], axis=-1)


@partial(jax.jit, static_argnums=(1, 2, 3))
def extract(img: jnp.ndarray, cfg: OrbConfig, height: int, width: int) -> Features:
    """Run the full ORB pipeline on a grayscale image [H, W] float32."""
    # f32 throughout: bf16 pyramid quantization (~±0.5 intensity) jitters
    # FAST corner positions and flips BRIEF comparison bits — measured as a
    # >10x ATE regression. The pyramid stages are compute-cheap anyway; the
    # expensive parts (resize, patches, BRIEF taps) are matmuls.
    canvas, _ = image_ops.build_pyramid(
        img, height, width, cfg.n_levels, cfg.scale_factor)
    # static per-level shapes (the jitted build_pyramid's returned tuple is
    # traced; recompute from the static args for use in slice bounds)
    shapes = image_ops.pyramid_shapes(height, width, cfg.n_levels,
                                      cfg.scale_factor)
    blurred = image_ops.gaussian_blur(canvas, 7, 2.0)
    quotas = orb_ops.feature_quotas(cfg.n_features, cfg.n_levels, cfg.scale_factor)

    # ONE threshold-free FAST strength pass per level, on the EXACT level
    # shape (the padded [L, H, W] canvas would spend 3.4x the FLOPs/bytes on
    # zero padding; slicing is free and shapes are static per level).
    def level_score(img_lv, h, w):
        strength = fast_ops.fast_strength(img_lv)
        s_hi = fast_ops.nms3x3(
            jnp.where(strength > float(cfg.ini_th_fast), strength, 0.0))
        s_lo = fast_ops.nms3x3(
            jnp.where(strength > float(cfg.min_th_fast), strength, 0.0))
        # Per-cell fallback (ORBextractor.cc:809-815): low threshold only in
        # cells where the high threshold found nothing.
        Hc, Wc = h // CELL, w // CELL
        hi_cells = s_hi[:Hc * CELL, :Wc * CELL].reshape(
            Hc, CELL, Wc, CELL).max(axis=(1, 3))
        has_hi = jnp.repeat(jnp.repeat(hi_cells > 0, CELL, 0), CELL, 1)
        has_hi = jnp.pad(has_hi, ((0, h - Hc * CELL), (0, w - Wc * CELL)))
        return jnp.where(has_hi, s_hi, s_lo)

    all_uv, all_resp, all_ang, all_lvl, all_desc = [], [], [], [], []
    for lv in range(cfg.n_levels):
        h, w = shapes[lv]
        score_lv = level_score(canvas[lv, :h, :w], h, w)
        cand_s, cand_uv = _level_candidates(score_lv, h, w)
        k = quotas[lv]
        k_eff = min(k, cand_s.shape[0])   # tiny levels: fewer cells than quota
        top_s, top_i = jax.lax.top_k(cand_s, k_eff)
        if k_eff < k:
            top_s = jnp.pad(top_s, (0, k - k_eff))
            top_i = jnp.pad(top_i, (0, k - k_eff))
        uv_lv = cand_uv[top_i]                       # [k, 2] level coords
        # Matmul patch extraction; angle from the raw level, bits from
        # blurred.
        ang = orb_ops.ic_angle_from_patches(
            orb_ops.extract_patches(canvas[lv], uv_lv))
        desc = orb_ops.brief_from_patches(
            orb_ops.extract_patches(blurred[lv], uv_lv), ang)
        sc = float(cfg.scale_factor) ** lv
        all_uv.append(uv_lv * sc)
        all_resp.append(top_s)
        all_ang.append(ang)
        all_lvl.append(jnp.full((k,), lv, jnp.int32))
        all_desc.append(desc)

    resp = jnp.concatenate(all_resp)
    return Features(
        uv=jnp.concatenate(all_uv, axis=0),
        response=resp,
        angle=jnp.concatenate(all_ang),
        level=jnp.concatenate(all_lvl),
        desc=jnp.concatenate(all_desc, axis=0),
        valid=resp > 0,
    )


def scale_factors(cfg: OrbConfig) -> jnp.ndarray:
    return jnp.asarray([cfg.scale_factor ** i for i in range(cfg.n_levels)],
                       jnp.float32)
