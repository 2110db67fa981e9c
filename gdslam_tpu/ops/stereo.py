"""Rectified stereo matching: descriptor coarse match + SAD subpixel refine.

Replaces Frame::ComputeStereoMatches (reference Frame.cc:638-813): for each
left keypoint, find the best right-image keypoint in the same row band by
Hamming distance within the disparity range, then refine the disparity with
an 11x11 SAD search (+-5 px) and parabolic subpixel interpolation; outputs
mvuRight and mvDepth.

Design: the per-row candidate lists become one dense [N, N] masked
Hamming matrix; SAD refinement extracts strips with the one-hot-matmul patch
machinery and evaluates all 11 offsets as a vectorized comparison.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gdslam_tpu.ops import hamming, orb as orb_ops

SAD_HALF = 5          # 11x11 window (Frame.cc:702 w=5)
SLIDE = 5             # +-5 px search (Frame.cc:714 L=5)


@partial(jax.jit, static_argnums=(8, 9))
def stereo_match(left_uv, left_level, left_desc, left_valid,
                 right_uv, right_level, right_desc, right_valid,
                 bf: float, min_z: float,
                 img_left=None, img_right=None, scale_factor: float = 1.2):
    """Returns (ur [N], depth [N]) per left keypoint (-1/0 where unmatched).

    min_z: minimum depth = baseline (Frame.cc:655 minD=0, maxD=bf/minZ).
    """
    b_over = bf / min_z                   # max disparity
    ham = hamming.hamming_matrix(
        orb_ops.descriptors_pm1(left_desc, left_valid),
        orb_ops.descriptors_pm1(right_desc, right_valid))
    # Row band: |vL - vR| <= 2 * scale^level (Frame.cc:664-676).
    band = 2.0 * scale_factor ** left_level.astype(jnp.float32)
    row_ok = jnp.abs(left_uv[:, None, 1] - right_uv[None, :, 1]) <= band[:, None]
    disp = left_uv[:, None, 0] - right_uv[None, :, 0]
    disp_ok = (disp >= -1.0) & (disp <= b_over)
    lvl_ok = jnp.abs(left_level[:, None] - right_level[None, :]) <= 1
    mask = row_ok & disp_ok & lvl_ok & left_valid[:, None] & right_valid[None, :]
    cost = jnp.where(mask, ham, 1 << 20)
    best = jnp.min(cost, axis=1)
    idx = jnp.argmin(cost, axis=1)
    matched = best < 75      # thOrbDist = (TH_HIGH + TH_LOW) / 2 (Frame.cc:660)

    uR0 = right_uv[idx, 0]
    if img_left is not None and img_right is not None:
        # SAD subpixel refinement around the coarse match (Frame.cc:698-770).
        lp = orb_ops.extract_patches(img_left, left_uv, 2 * SAD_HALF + 1)
        strip = orb_ops.extract_patches(
            img_right, jnp.stack([uR0, left_uv[:, 1]], 1),
            2 * (SAD_HALF + SLIDE) + 1)
        c0 = SAD_HALF + SLIDE
        sads = []
        for off in range(-SLIDE, SLIDE + 1):
            win = strip[:, c0 - SAD_HALF:c0 + SAD_HALF + 1,
                        c0 + off - SAD_HALF:c0 + off + SAD_HALF + 1]
            sads.append(jnp.sum(jnp.abs(win - lp), axis=(1, 2)))
        sad = jnp.stack(sads, axis=1)                  # [N, 11]
        k = jnp.argmin(sad, axis=1)
        interior = (k > 0) & (k < 2 * SLIDE)
        km = jnp.clip(k, 1, 2 * SLIDE - 1)
        s_m1 = jnp.take_along_axis(sad, (km - 1)[:, None], 1)[:, 0]
        s_0 = jnp.take_along_axis(sad, km[:, None], 1)[:, 0]
        s_p1 = jnp.take_along_axis(sad, (km + 1)[:, None], 1)[:, 0]
        denom = jnp.maximum(s_m1 - 2 * s_0 + s_p1, 1e-6)
        delta = jnp.clip(0.5 * (s_m1 - s_p1) / denom, -1.0, 1.0)
        refine = (km.astype(jnp.float32) - SLIDE) + jnp.where(interior, delta, 0.0)
        uR = uR0 + refine
    else:
        uR = uR0

    disparity = left_uv[:, 0] - uR
    ok = matched & (disparity > 0.1) & (disparity <= b_over)
    depth = jnp.where(ok, bf / jnp.maximum(disparity, 1e-6), 0.0)
    ur = jnp.where(ok, uR, -1.0)
    return ur, depth
