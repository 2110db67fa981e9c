"""Per-frame feature post-processing: mask culling, undistortion, RGB-D
stereo association.

Mirrors Frame's RGB-D constructor pipeline (reference Frame.cc:236-317):
- mask-based keypoint deletion: erode the static-mask then keep keypoints
  where mask==1 (Frame.cc:174-199 — the reference calls cv::erode with a
  31x31 ellipse despite the "dilation" naming). Here the erosion is a
  separable 31x31 min-pool (square SE; conservative superset of the disk).
- UndistortKeyPoints (Frame.cc:576) via the camera model.
- ComputeStereoFromRGBD (Frame.cc:815-838): mvuRight = u - bf/z with depth
  sampled at the *distorted* keypoint location.

The 64x48 feature grid (Frame.cc:402-417) is intentionally absent: windowed
search is done with dense masked distance matrices (see
frontend/matcher.py), the fixed-shape equivalent.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gdslam_tpu.config import CameraConfig
from gdslam_tpu.core import camera
from gdslam_tpu.frontend.extractor import Features


class Frame(NamedTuple):
    """Processed frame: features + geometry, fixed-size padded."""

    uv: jnp.ndarray        # [N, 2] undistorted keypoint pixels
    uv_raw: jnp.ndarray    # [N, 2] original (distorted) pixels
    ur: jnp.ndarray        # [N] right-view u coordinate (<0 = no depth)
    depth: jnp.ndarray     # [N] keypoint depth (0 = invalid)
    level: jnp.ndarray     # [N] int32
    angle: jnp.ndarray     # [N]
    response: jnp.ndarray  # [N]
    desc: jnp.ndarray      # [N, 32] uint8
    valid: jnp.ndarray     # [N] bool (extraction valid AND mask-pass)


def _erode_ksize(width: int) -> int:
    """The reference erodes with a fixed 31x31 SE on 640-px-wide TUM frames
    (Frame.cc:174-199); the margin is a fraction of image width, so scale
    it with resolution (odd, >=3) for smaller rigs."""
    return max(3, int(round(31 * width / 640.0)) | 1)


def erode_mask(mask: jnp.ndarray, ksize: int = 31) -> jnp.ndarray:
    """Binary erosion with a ksize x ksize square SE (separable min-pool)."""
    m = mask.astype(jnp.float32)
    m = -jax.lax.reduce_window(-m, -jnp.inf, jax.lax.max, (ksize, 1), (1, 1),
                               "SAME")
    m = -jax.lax.reduce_window(-m, -jnp.inf, jax.lax.max, (1, ksize), (1, 1),
                               "SAME")
    return m > 0.5


def dilate_mask(mask: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """Binary dilation with a square SE (separable max-pool)."""
    m = mask.astype(jnp.float32)
    m = jax.lax.reduce_window(m, -jnp.inf, jax.lax.max, (ksize, 1), (1, 1), "SAME")
    m = jax.lax.reduce_window(m, -jnp.inf, jax.lax.max, (1, ksize), (1, 1), "SAME")
    return m > 0.5


@partial(jax.jit, static_argnums=(4,))
def build_frame_stereo(feats: Features, ur: jnp.ndarray, kp_depth: jnp.ndarray,
                       static_mask: jnp.ndarray, cam: CameraConfig) -> Frame:
    """Assemble a Frame from per-keypoint stereo matches (ur, depth) —
    the stereo constructor path (Frame.cc:53-154) where depth comes from
    ComputeStereoMatches instead of a depth map."""
    H, W = cam.height, cam.width
    u = jnp.clip(jnp.round(feats.uv[:, 0]).astype(jnp.int32), 0, W - 1)
    v = jnp.clip(jnp.round(feats.uv[:, 1]).astype(jnp.int32), 0, H - 1)
    eroded = erode_mask(static_mask, _erode_ksize(W))
    keep = feats.valid & eroded[v, u]
    uv_und = camera.undistort_points(feats.uv, cam)
    return Frame(uv=uv_und, uv_raw=feats.uv, ur=ur, depth=kp_depth,
                 level=feats.level, angle=feats.angle, response=feats.response,
                 desc=feats.desc, valid=keep)


@partial(jax.jit, static_argnums=(3,))
def build_frame(feats: Features, depth_map: jnp.ndarray, static_mask: jnp.ndarray,
                cam: CameraConfig) -> Frame:
    """Assemble a Frame from extractor output + depth + static mask.

    static_mask: [H, W] 1 = static (keep), 0 = dynamic (cull), matching the
    reference convention (mask = ones - maskRCNN; rgbd_tum.cc:137-150).
    """
    H, W = cam.height, cam.width
    u = jnp.clip(jnp.round(feats.uv[:, 0]).astype(jnp.int32), 0, W - 1)
    v = jnp.clip(jnp.round(feats.uv[:, 1]).astype(jnp.int32), 0, H - 1)
    eroded = erode_mask(static_mask, _erode_ksize(W))
    keep = feats.valid & eroded[v, u]
    z = depth_map[v, u]
    z = jnp.where(z > 0, z, 0.0)
    uv_und = camera.undistort_points(feats.uv, cam)
    ur = jnp.where(z > 0, uv_und[:, 0] - cam.bf / jnp.maximum(z, 1e-6), -1.0)
    return Frame(uv=uv_und, uv_raw=feats.uv, ur=ur, depth=z, level=feats.level,
                 angle=feats.angle, response=feats.response, desc=feats.desc,
                 valid=keep)
