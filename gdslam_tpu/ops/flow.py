"""Farneback dense optical flow as a jitted pyramid transform.

Replaces cv::calcOpticalFlowFarneback as used by GeoMaskMaker::GetFlow
(reference GeoMaskMaker.cc:158-166) with parameters
(pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5,
poly_sigma=1.2).

Algorithm (Farneback 2003): approximate each neighborhood by a quadratic
polynomial via Gaussian-weighted least squares ("polynomial expansion"),
then solve for the displacement field that maps one expansion onto the
other, smoothed over a window, iterated coarse-to-fine over a pyramid.
Everything is convolutions + bilinear warps — dense elementwise work that XLA fuses;
there is no per-pixel branching.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gdslam_tpu.ops import image as image_ops


def _poly_exp_filters(n: int, sigma: float):
    """Least-squares projection filters for basis (1, x, y, x2, y2, xy)."""
    xs = np.arange(-n, n + 1)
    X, Y = np.meshgrid(xs, xs)  # [k, k], X varies along axis 1
    w = np.exp(-(X ** 2 + Y ** 2) / (2 * sigma ** 2))
    B = np.stack([np.ones_like(X), X, Y, X ** 2, Y ** 2, X * Y],
                 axis=-1).reshape(-1, 6).astype(np.float64)
    W = np.diag(w.reshape(-1))
    M = np.linalg.solve(B.T @ W @ B, B.T @ W)      # [6, k*k]
    k = 2 * n + 1
    # numpy, NOT jnp: this is a module-level constant, and flow.py can be
    # first imported INSIDE a trace (device_track_step lazily imports
    # geomask when the GD ring is active) — a jnp constant created there
    # becomes a leaked tracer (tests/test_no_hoisted_consts.py).
    return np.asarray(M.reshape(6, k, k), np.float32)


_POLY_FILTERS = _poly_exp_filters(2, 1.2)          # poly_n=5 -> radius 2


def _correlate(img: jnp.ndarray, kernels: jnp.ndarray) -> jnp.ndarray:
    """Correlate [H, W] with [C, k, k] kernels -> [C, H, W] (reflect pad)."""
    k = kernels.shape[-1]
    pad = k // 2
    x = jnp.pad(img, pad, mode="reflect")[None, None]
    # NB: lax conv is correlation (no kernel flip), which is what we want.
    out = jax.lax.conv_general_dilated(
        x, kernels[:, None], (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return out[0]


def poly_expansion(img: jnp.ndarray):
    """Per-pixel quadratic fit: returns (A [H,W,2,2], b [H,W,2])."""
    r = _correlate(img, _POLY_FILTERS)             # [6, H, W]
    b = jnp.stack([r[1], r[2]], axis=-1)
    A = jnp.stack([
        jnp.stack([r[3], r[5] * 0.5], axis=-1),
        jnp.stack([r[5] * 0.5, r[4]], axis=-1),
    ], axis=-2)
    return A, b


def _box_blur(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """Separable box filter on [..., H, W] (the winsize smoothing)."""
    w = jnp.ones(size) / size
    pad = size // 2
    H, W = x.shape[-2], x.shape[-1]
    y = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(pad, pad), (0, 0)], mode="reflect")
    y = sum(w[i] * jax.lax.slice_in_dim(y, i, i + H, axis=x.ndim - 2)
            for i in range(size))
    y = jnp.pad(y, [(0, 0)] * (x.ndim - 2) + [(0, 0), (pad, pad)], mode="reflect")
    return sum(w[i] * jax.lax.slice_in_dim(y, i, i + W, axis=x.ndim - 1)
               for i in range(size))


def _flow_step(A1, b1, img2, flow, winsize: int):
    """One Farneback displacement update.

    The textbook form warps the 6 polynomial-expansion fields of image 2 by
    the current flow (6 dense gathers). Instead we warp IMAGE 2 once and
    re-expand it (one gather + cheap convolutions): the classic pyramidal
    warping formulation.
    """
    H, W = flow.shape[:2]
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    uv = jnp.stack([u + flow[..., 0], v + flow[..., 1]], axis=-1)
    img2w = image_ops.bilinear_sample(img2, uv)
    A2w, b2w = poly_expansion(img2w)
    A = 0.5 * (A1 + A2w)
    db = -0.5 * (b2w - b1) + jnp.einsum("hwij,hwj->hwi", A, flow)
    # Normal equations smoothed over the window.
    G = jnp.einsum("hwki,hwkj->hwij", A, A)        # A^T A
    h = jnp.einsum("hwki,hwk->hwi", A, db)
    G = _box_blur(G.transpose(2, 3, 0, 1), winsize).transpose(2, 3, 0, 1)
    h = _box_blur(h.transpose(2, 0, 1), winsize).transpose(1, 2, 0)
    det = G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0]
    det = jnp.where(jnp.abs(det) > 1e-9, det, 1e-9)
    fx = (G[..., 1, 1] * h[..., 0] - G[..., 0, 1] * h[..., 1]) / det
    fy = (G[..., 0, 0] * h[..., 1] - G[..., 1, 0] * h[..., 0]) / det
    return jnp.stack([fx, fy], axis=-1)


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def farneback_flow(img1: jnp.ndarray, img2: jnp.ndarray, levels: int = 3,
                   winsize: int = 15, iterations: int = 3,
                   finest_level: int = 0, upsample: bool = True) -> jnp.ndarray:
    """Dense flow img1 -> img2, [H, W, 2] (du, dv) in pixels.

    finest_level > 0 stops the coarse-to-fine refinement early and
    upsamples the result — e.g. finest_level=1 computes at half resolution
    (4x cheaper warps) which is plenty for the Mahalanobis masker (its
    consumers sample the flow bilinearly anyway).

    upsample=False returns the flow AT finest_level's resolution, in
    finest_level pixel units (for consumers that themselves run at reduced
    resolution, e.g. the half-res Mahalanobis masker).
    """
    H, W = img1.shape
    # Build pyramids (scale 0.5).
    p1, p2 = [img1], [img2]
    shapes = [(H, W)]
    for lv in range(1, levels):
        h, w = shapes[-1][0] // 2, shapes[-1][1] // 2
        p1.append(image_ops.resize_bilinear(p1[-1], h, w))
        p2.append(image_ops.resize_bilinear(p2[-1], h, w))
        shapes.append((h, w))
    flow = jnp.zeros(shapes[-1] + (2,))
    for lv in range(levels - 1, finest_level - 1, -1):
        A1, b1 = poly_expansion(p1[lv])
        for _ in range(iterations):
            flow = _flow_step(A1, b1, p2[lv], flow, winsize)
        if lv == finest_level and not upsample:
            return flow
        if lv > 0:
            h, w = shapes[lv - 1]
            flow = 2.0 * jnp.stack(
                [image_ops.resize_bilinear(flow[..., 0], h, w),
                 image_ops.resize_bilinear(flow[..., 1], h, w)], axis=-1)
    return flow
