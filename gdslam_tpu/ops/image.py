"""Image primitives: separable Gaussian blur, bilinear resize/remap, pyramid.

Replaces the reference's OpenCV usage in ORBextractor::ComputePyramid
(ORBextractor.cc:1107-1132: cv::resize INTER_LINEAR, scale 1.2, 8 levels) and
the 7x7 sigma-2 GaussianBlur applied before descriptor computation
(ORBextractor.cc:1085-1086).

Design: all pyramid levels live in ONE fixed-shape [L, H, W] canvas with
per-level valid sizes, so every downstream op (FAST, blur, descriptor
sampling) is a single vmapped kernel over the level axis with static shapes.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def gaussian_kernel_1d(ksize: int, sigma: float, dtype=jnp.float32) -> jnp.ndarray:
    """Matches cv::getGaussianKernel semantics (normalized)."""
    half = (ksize - 1) / 2.0
    x = np.arange(ksize) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return jnp.asarray(k, dtype)


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur on [..., H, W] with reflect padding."""
    k = gaussian_kernel_1d(ksize, sigma, img.dtype)
    pad = ksize // 2
    x = jnp.pad(img, [(0, 0)] * (img.ndim - 2) + [(pad, pad), (0, 0)], mode="reflect")
    # Convolve rows: sum of shifted slices (ksize is small; XLA fuses this).
    H = img.shape[-2]
    out = sum(k[i] * jax.lax.slice_in_dim(x, i, i + H, axis=img.ndim - 2)
              for i in range(ksize))
    x = jnp.pad(out, [(0, 0)] * (img.ndim - 2) + [(0, 0), (pad, pad)], mode="reflect")
    W = img.shape[-1]
    out = sum(k[i] * jax.lax.slice_in_dim(x, i, i + W, axis=img.ndim - 1)
              for i in range(ksize))
    return out


def bilinear_sample(img: jnp.ndarray, uv: jnp.ndarray,
                    fill: float = 0.0) -> jnp.ndarray:
    """Sample img[H, W] at float pixel coords uv[..., 2] = (u=x, v=y).

    Out-of-bounds samples return `fill`. This is the workhorse behind
    remap/warp (reference cv::remap in inpainting) and descriptor sampling.

    Formulation: instead of four `img[vi, ui]` advanced-index reads (four
    2-D gathers), the four taps of each pixel's 2x2 footprint are
    pre-packed into contiguous rows of a [(H+1)*(W+1), 4] array (cheap
    shifted-slice writes), so the whole bilinear read is ONE row gather.
    """
    H, W = img.shape[-2], img.shape[-1]
    u, v = uv[..., 0], uv[..., 1]
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    du, dv = u - u0, v - v0
    u0i, v0i = u0.astype(jnp.int32), v0.astype(jnp.int32)

    # quad[y, x] = (p[y,x], p[y,x+1], p[y+1,x], p[y+1,x+1]) on the 1-padded
    # image: grid position (y, x) covers source coords (y-1, x-1), so taps
    # at u0 = -1 / v0 = -1 (partially-inside footprints) stay exact.
    p = jnp.pad(img, 1)
    quad = jnp.stack([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]],
                     axis=-1)                           # [H+1, W+1, 4]
    quad = quad.reshape(-1, 4)
    gx = jnp.clip(u0i, -1, W - 1) + 1
    gy = jnp.clip(v0i, -1, H - 1) + 1
    t = quad[gy * (W + 1) + gx]                         # [..., 4] one gather

    def tap(val, vi, ui):
        inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        return jnp.where(inb, val, fill)

    w00 = (1 - du) * (1 - dv)
    w01 = du * (1 - dv)
    w10 = (1 - du) * dv
    w11 = du * dv
    return (w00 * tap(t[..., 0], v0i, u0i)
            + w01 * tap(t[..., 1], v0i, u0i + 1)
            + w10 * tap(t[..., 2], v0i + 1, u0i)
            + w11 * tap(t[..., 3], v0i + 1, u0i + 1))


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] 1-D linear-interpolation matrix (pixel-center aligned,
    cv::resize INTER_LINEAR semantics)."""
    s = n_in / n_out
    x = (np.arange(n_out) + 0.5) * s - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
    x1 = np.clip(x0 + 1, 0, n_in - 1)
    f = np.clip(x - x0, 0.0, 1.0)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), x0] += 1.0 - f
    M[np.arange(n_out), x1] += f
    return M


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """cv::resize INTER_LINEAR-compatible resize.

    Implemented as two static interpolation-matrix products (R @ img @ C^T)
    instead of a gather (whether a gather is cheaper on the GPU is
    ROADMAP A4). Pinned to full float32: in TF32 the pyramid levels move
    FAST keypoints (PERF.md).
    """
    H, W = img.shape
    R = jnp.asarray(_interp_matrix(H, out_h), img.dtype)
    C = jnp.asarray(_interp_matrix(W, out_w), img.dtype)
    return jnp.einsum("oh,hw,pw->op", R, img, C,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=img.dtype)


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float):
    """Per-level (h, w) using the reference's rounding (ORBextractor.cc:1110)."""
    shapes = []
    for lv in range(n_levels):
        inv = 1.0 / (scale ** lv)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def build_pyramid(img: jnp.ndarray, height: int, width: int,
                  n_levels: int = 8, scale: float = 1.2) -> tuple[jnp.ndarray, tuple]:
    """Build the scale pyramid into one [L, H, W] canvas.

    Level lv occupies the top-left (h_lv, w_lv) region; the rest is zero.
    Each level is resized from the previous (matching the reference's
    successive cv::resize), all with static shapes.
    """
    shapes = pyramid_shapes(height, width, n_levels, scale)
    canvas = jnp.zeros((n_levels, height, width), img.dtype)
    canvas = canvas.at[0].set(img)
    prev = img
    for lv in range(1, n_levels):
        h, w = shapes[lv]
        level = resize_bilinear(prev, h, w)
        canvas = canvas.at[lv, :h, :w].set(level)
        prev = level
    return canvas, tuple(shapes)


def valid_mask(height: int, width: int, shapes) -> jnp.ndarray:
    """[L, H, W] bool mask of valid pixels per level."""
    L = len(shapes)
    ys = jax.lax.broadcasted_iota(jnp.int32, (L, height, width), 1)
    xs = jax.lax.broadcasted_iota(jnp.int32, (L, height, width), 2)
    hs = jnp.asarray([s[0] for s in shapes])[:, None, None]
    ws = jnp.asarray([s[1] for s in shapes])[:, None, None]
    return (ys < hs) & (xs < ws)
