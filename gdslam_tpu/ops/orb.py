"""ORB keypoint orientation + rBRIEF descriptors, batched over keypoints.

Replaces the reference's IC_Angle (ORBextractor.cc:77-104) and
computeOrbDescriptor (ORBextractor.cc:108-147).

Design notes:
- Patches are gathered per keypoint with vmapped dynamic_slice; moments and
  descriptor taps are then dense [K, ...] math.
- The 256 sampling pairs are a deterministic seeded BRIEF pattern
  (Gaussian(0, (S/5)^2), the BRIEF-paper distribution) rather than the
  reference's learned `bit_pattern_31_` table: descriptors here never need to
  be bit-compatible with OpenCV's (matching, BoW vocabulary, and loop closure
  are all trained/computed in-framework), and an original pattern keeps the
  implementation clean-room. Pattern points are clipped to radius 13 so that
  any rotation stays inside the 31x31 patch.
- Rotation is continuous (per-keypoint sin/cos), sampling is
  round-to-nearest like the reference's cvRound.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

PATCH = 31
HALF_PATCH = 15
N_BITS = 256
# The matmuls below copy or select pixel values; on the GPU a float32
# matmul otherwise runs in TF32, which rounds the values it copies
# (PERF.md: TF32 moved keypoints and descriptor bits against the CPU).
_COPY = jax.lax.Precision.HIGHEST


def _np_pattern(seed: int = 42, n_bits: int = N_BITS) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 2, 2))
    r = np.sqrt((pts ** 2).sum(-1, keepdims=True))
    pts = np.where(r > 13.0, pts * (13.0 / r), pts)
    return np.round(pts).astype(np.float32)  # [256, 2 taps, (x, y)]


# Host (numpy) constant: baked into HLO as a literal; an eager jnp array
# would be hoisted as a hidden executable parameter (see backend/mapping.py).
BRIEF_PATTERN = _np_pattern()   # [256, 2, 2]


def _circular_mask_and_coords():
    """31x31 circular footprint + x/y coordinate grids for IC moments."""
    ys, xs = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    mask = (xs * xs + ys * ys) <= HALF_PATCH * HALF_PATCH
    return (jnp.asarray(mask, jnp.float32), jnp.asarray(xs, jnp.float32),
            jnp.asarray(ys, jnp.float32))


_IC_MASK, _IC_X, _IC_Y = _circular_mask_and_coords()


PATCH_EXT = 37        # 2*18+1: covers any rotation of the r<=13 pattern
_EXT_HALF = PATCH_EXT // 2
N_ANGLE_BINS = 30     # 12-degree rotation quantization (OpenCV-ORB style)


def extract_patches(img: jnp.ndarray, uv: jnp.ndarray,
                    size: int = PATCH_EXT) -> jnp.ndarray:
    """[K, size, size] patches centered at round(uv), out-of-image = 0.

    Formulated as two one-hot matmuls instead of a gather (whether a
    gather is cheaper on the GPU is ROADMAP A4).
    """
    H, W = img.shape
    half = size // 2
    u = jnp.round(uv[:, 0]).astype(jnp.int32)
    v = jnp.round(uv[:, 1]).astype(jnp.int32)
    rows = v[:, None] + jnp.arange(-half, half + 1)[None]      # [K, size]
    cols = u[:, None] + jnp.arange(-half, half + 1)[None]
    # f32 one-hot products copy pixel values EXACTLY — descriptor bits are
    # comparisons of near-equal smoothed values, so rounding here flips bits.
    Roh = (rows[:, :, None] == jnp.arange(H)[None, None]).astype(jnp.float32)
    Coh = (cols[:, :, None] == jnp.arange(W)[None, None]).astype(jnp.float32)
    t = jnp.einsum("krh,hw->krw", Roh, img.astype(jnp.float32),
                   precision=_COPY, preferred_element_type=jnp.float32)
    return jnp.einsum("krw,kcw->krc", t, Coh, precision=_COPY,
                      preferred_element_type=jnp.float32)


def gather_patches(img: jnp.ndarray, uv: jnp.ndarray, size: int = PATCH) -> jnp.ndarray:
    """[K, size, size] patches (clamped at borders) — small-K utility."""
    H, W = img.shape
    half = size // 2
    u = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32) - half, 0, W - size)
    v = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32) - half, 0, H - size)

    def slice_one(vu):
        return jax.lax.dynamic_slice(img, (vu[0], vu[1]), (size, size))

    return jax.vmap(slice_one)(jnp.stack([v, u], axis=1))


def ic_angle_from_patches(patches: jnp.ndarray) -> jnp.ndarray:
    """Orientation from [K, 37, 37] patches (31x31 circular interior)."""
    inner = patches[:, 3:3 + PATCH, 3:3 + PATCH].astype(jnp.float32)
    w = inner * _IC_MASK
    m10 = jnp.sum(w * _IC_X, axis=(1, 2))
    m01 = jnp.sum(w * _IC_Y, axis=(1, 2))
    return jnp.arctan2(m01, m10)


def ic_angle(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation (radians) per keypoint.

    Same moments as IC_Angle (ORBextractor.cc:77-104): angle =
    atan2(m01, m10) over the circular 31x31 patch.
    """
    return ic_angle_from_patches(extract_patches(img, uv))


def _np_bin_matrix() -> np.ndarray:
    """[37*37, N_ANGLE_BINS * 512] static tap-selection matrix: for rotation
    bin b and tap t (2 per bit), column b*512+t selects the patch pixel the
    rotated pattern samples. BRIEF sampling then becomes one matmul."""
    pat = _np_pattern()                        # [256, 2, (x, y)]
    G = np.zeros((PATCH_EXT * PATCH_EXT, N_ANGLE_BINS * 512), np.float32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        rx = np.round(pat[..., 0] * ca - pat[..., 1] * sa).astype(int)
        ry = np.round(pat[..., 0] * sa + pat[..., 1] * ca).astype(int)
        rx = np.clip(rx, -_EXT_HALF, _EXT_HALF)
        ry = np.clip(ry, -_EXT_HALF, _EXT_HALF)
        flat = (ry + _EXT_HALF) * PATCH_EXT + (rx + _EXT_HALF)   # [256, 2]
        cols = b * 512 + np.arange(512)
        G[flat.reshape(-1), cols] = 1.0
    return G


_BIN_MATRIX = _np_bin_matrix().astype(np.float32)


def brief_from_patches(patches: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Packed descriptors from [K, 37, 37] patches + angles: one matmul
    against the static rotation-bin matrix, then per-keypoint bin selection.
    """
    K = patches.shape[0]
    flat = patches.reshape(K, -1).astype(jnp.float32)
    S = jnp.einsum("kp,pc->kc", flat, _BIN_MATRIX, precision=_COPY,
                   preferred_element_type=jnp.float32)
    S = S.reshape(K, N_ANGLE_BINS, 512)
    bins = jnp.mod(jnp.round(angle / (2 * jnp.pi / N_ANGLE_BINS)).astype(jnp.int32),
                   N_ANGLE_BINS)
    boh = (bins[:, None] == jnp.arange(N_ANGLE_BINS)[None]).astype(jnp.float32)
    V = jnp.einsum("kb,kbs->ks", boh, S, precision=_COPY)       # [K, 512]
    bits = V[:, 0::2] < V[:, 1::2]
    return pack_bits(bits)


def brief_descriptors(img_blurred: jnp.ndarray, uv: jnp.ndarray,
                      angle: jnp.ndarray) -> jnp.ndarray:
    """Rotated-BRIEF descriptors, packed [K, 32] uint8.

    Bit i = I(p + R(angle) q_i1) < I(p + R(angle) q_i2), matching the
    comparison sense of computeOrbDescriptor (ORBextractor.cc:108-147);
    rotation quantized to 12-degree bins so sampling is a static matmul.
    """
    return brief_from_patches(extract_patches(img_blurred, uv), angle)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """[..., 256] bool -> [..., 32] uint8 (little-endian bit order)."""
    b = bits.reshape(bits.shape[:-1] + (32, 8)).astype(jnp.uint8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))
    return jnp.sum(b * weights, axis=-1).astype(jnp.uint8)


def unpack_bits(packed: jnp.ndarray) -> jnp.ndarray:
    """[..., 32] uint8 -> [..., 256] bool."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    b = (packed[..., None] >> shifts) & jnp.uint8(1)
    return b.reshape(packed.shape[:-1] + (256,)).astype(jnp.bool_)


def descriptors_pm1(packed: jnp.ndarray, valid=None) -> jnp.ndarray:
    """[..., 32] uint8 -> [..., 256] int8 in {-1, +1} for the int8
    Hamming matmul (ops/hamming.py).

    Invalid rows (valid == False) become all-zero so their dot products
    vanish instead of matching.
    """
    pm1 = jnp.where(unpack_bits(packed), jnp.int8(1), jnp.int8(-1))
    if valid is not None:
        pm1 = jnp.where(valid[..., None], pm1, jnp.int8(0))
    return pm1


def feature_quotas(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Per-level keypoint budget, geometric in 1/scale — same scheme as the
    reference ORBextractor ctor (ORBextractor.cc:410)."""
    f = 1.0 / scale
    first = n_features * (1 - f) / (1 - f ** n_levels)
    quotas, total = [], 0
    for lv in range(n_levels - 1):
        q = int(round(first * f ** lv))
        quotas.append(q)
        total += q
    quotas.append(max(n_features - total, 0))
    return quotas
