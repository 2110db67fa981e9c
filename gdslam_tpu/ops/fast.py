"""FAST-9/16 corner detection as a fully-vectorized XLA transform.

Replaces cv::FAST as used by the reference's grid extractor
(ORBextractor.cc:765-853: threshold 20 with per-cell fallback to 7).

Design: instead of branchy per-pixel arc walks, the 16 Bresenham-circle
taps become 16 rolled copies of the image; the "9 contiguous" test is a
bit-trick on a packed 16-bit mask (doubled to 32 bits, AND of 8 shifts), and
the corner score is the classic max-over-arcs of min-over-arc |difference|,
computed with a log-step circular min. Everything is elementwise on [H, W]
maps — elementwise work that XLA fuses into one program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx),
# standard FAST-16 tap ordering.
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _circle_taps(img: jnp.ndarray) -> jnp.ndarray:
    """[16, ..., H, W] rolled images so tap k at pixel p = img[p + offset_k]."""
    taps = [jnp.roll(img, shift=(-dy, -dx), axis=(-2, -1))
            for dy, dx in CIRCLE_OFFSETS]
    return jnp.stack(taps, axis=0)


def _has_arc9(mask16: jnp.ndarray) -> jnp.ndarray:
    """mask16: [16, ..., H, W] bool -> bool map of 'exists >=9 contiguous'."""
    bits = jnp.zeros(mask16.shape[1:], jnp.int32)
    for k in range(16):
        bits = bits | (mask16[k].astype(jnp.int32) << k)
    doubled = bits | (bits << 16)
    acc = doubled
    for k in range(1, 9):
        acc = acc & (doubled >> k)
    return (acc & 0xFFFF) != 0


def _arc9_min_strength(d: jnp.ndarray) -> jnp.ndarray:
    """d: [16, ..., H, W] signed strengths. Returns max over the 16 circular
    9-arcs of (min over the arc), i.e. the largest t such that some 9-arc is
    uniformly > t. Negative values mean 'no arc'.
    """
    # min over runs of 2, 4, 8 via log-step rolls on the circular tap axis.
    m2 = jnp.minimum(d, jnp.roll(d, -1, axis=0))
    m4 = jnp.minimum(m2, jnp.roll(m2, -2, axis=0))
    m8 = jnp.minimum(m4, jnp.roll(m4, -4, axis=0))
    m9 = jnp.minimum(m8, jnp.roll(d, -8, axis=0))
    return jnp.max(m9, axis=0)


def fast_strength(img: jnp.ndarray) -> jnp.ndarray:
    """Threshold-free FAST-9/16 corner strength: the largest threshold at
    which the pixel is still a corner (OpenCV cornerScore semantics).
    <=0 means not a corner at any threshold. Border 3 px zeroed.

    One strength map serves every threshold: score_t = strength * (strength
    > t) — the extractor's high/low threshold pair reuses this single pass.
    """
    taps = _circle_taps(img)
    center = img[None]
    brighter_strength = _arc9_min_strength(taps - center)   # > t  -> bright corner
    darker_strength = _arc9_min_strength(center - taps)     # < -t -> dark corner
    strength = jnp.maximum(brighter_strength, darker_strength)
    # Zero the 3px border (rolled taps wrap around).
    H, W = img.shape[-2], img.shape[-1]
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inner = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return jnp.where(inner, strength, 0.0)


def fast_score(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """FAST-9/16 corner response at a threshold. 0 where not a corner."""
    s = fast_strength(img)
    return jnp.where(s > threshold, s, 0.0)


def fast_corners(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Boolean corner map (no NMS)."""
    taps = _circle_taps(img)
    center = img[None]
    is_corner = _has_arc9(taps > center + threshold) | _has_arc9(taps < center - threshold)
    H, W = img.shape[-2], img.shape[-1]
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inner = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return is_corner & inner


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep scores that are the strict max of their 3x3 neighborhood."""
    neigh = [jnp.roll(score, (dy, dx), axis=(-2, -1))
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
    nmax = jnp.stack(neigh, 0).max(axis=0)
    return jnp.where(score > nmax, score, 0.0)
