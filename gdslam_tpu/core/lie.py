"""SO3 / SE3 / Sim3 Lie-group operations for pose optimization.

The reference relies on g2o's `se3quat.h` / `sim3.h`
(reference Thirdparty/g2o/g2o/types/) for its exp/log maps and on
`types_six_dof_expmap` for the SE3 BA edge Jacobians (used by
Optimizer.cc:239-451 and 997-1260). Here the same math is expressed as pure
JAX functions, closed-form and `vmap`/`jit`-friendly: all branching is
`jnp.where` on Taylor fallbacks so the functions are safe under `grad` and at
theta -> 0.

Conventions: rotations are 3x3 matrices; SE3 tangent is (upsilon, omega) =
(translation, rotation), matching g2o's SE3Quat ordering internally
[omega, upsilon] is NOT used — we keep [upsilon, omega] and are consistent
throughout. Sim3 tangent is (upsilon, omega, sigma) with scale s = exp(sigma).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8

# Accelerator matmuls default to reduced-precision inputs (TF32 on the GPU);
# for 3x3/4x4 pose algebra that costs ~pixel-level reprojection error. All
# products here are tiny, so pin them to full f32 precision.
_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


def _mv(A, x):
    return jnp.einsum("...ij,...j->...i", A, x, precision=_PREC)


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of a 3-vector (batched on leading dims)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], axis=-1),
        jnp.stack([wz, z, -wx], axis=-1),
        jnp.stack([-wy, wx, z], axis=-1),
    ], axis=-2)


def vee(W: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula, Taylor-safe at ||w|| -> 0."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = _mm(W, W)
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Log map of SO3. Safe near identity; not meant for theta ~ pi exactly."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_t)
    sin_t = jnp.sin(theta)
    factor = jnp.where(jnp.abs(theta) > 1e-5, theta / (2.0 * sin_t + _EPS), 0.5 + theta * theta / 12.0)
    return factor[..., None] * vee(R - jnp.swapaxes(R, -1, -2))


def _so3_left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """V matrix such that se3 translation t = V @ upsilon."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = _mm(W, W)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = jnp.where(theta2 > _EPS, (theta - jnp.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


def _so3_left_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = _mm(W, W)
    half_theta = 0.5 * theta
    cot = jnp.where(
        theta2 > _EPS,
        (1.0 - half_theta * jnp.cos(half_theta) / (jnp.sin(half_theta) + _EPS)) / (theta2 + _EPS),
        1.0 / 12.0 + theta2 / 720.0,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot[..., None, None] * W2


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Tangent [upsilon(3), omega(3)] -> 4x4 homogeneous transform."""
    v, w = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    t = _mv(_so3_left_jacobian(w), v)
    return rt_to_mat(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    v = _mv(_so3_left_jacobian_inv(w), t)
    return jnp.concatenate([v, w], axis=-1)


def rt_to_mat(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    return T.at[..., 3, 3].set(1.0)


def se3_inverse(T: jnp.ndarray) -> jnp.ndarray:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_mat(Rt, -_mv(Rt, t))


def se3_apply(T: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply 4x4 transform(s) to 3D point(s); broadcasts on leading dims."""
    return _mv(T[..., :3, :3], p) + T[..., :3, 3]


def so3_project(R: jnp.ndarray, iters: int = 3) -> jnp.ndarray:
    """Project near-orthogonal R onto SO(3) by Newton-Schulz polar iteration
    R <- 0.5 R (3I - R^T R); quadratic convergence for ||R^T R - I|| < 1.

    Load-bearing: the per-frame tracking cycle computes
    vel = T_cur @ se3_inverse(T_prev); se3_inverse is the TRANSPOSE inverse,
    which is wrong for a non-orthogonal R, so any deviation from SO(3)
    AMPLIFIES geometrically (measured x2.4/frame — float32 rounding alone
    reaches det(R)=1.14 within ~20 frames and breaks every downstream
    transpose-inverse, including loop-closure propagation). GN pose updates
    (exp(xi) @ T) preserve but never remove the deviation, so the state
    boundary must re-project. 3 tiny matmuls, no SVD."""
    I = jnp.eye(3, dtype=R.dtype)
    for _ in range(iters):
        R = 0.5 * _mm(R, 3.0 * I - _mm(jnp.swapaxes(R, -1, -2), R))
    return R


def se3_orthonormalize(T: jnp.ndarray) -> jnp.ndarray:
    """Re-project the rotation block of (a batch of) rigid transforms onto
    SO(3), keeping translation; see so3_project for why this is required."""
    return rt_to_mat(so3_project(T[..., :3, :3]), T[..., :3, 3])


# ----------------------------------------------------------------------------
# Sim3 (for loop closing / essential graph; reference sim3.h + Sim3Solver)
# ----------------------------------------------------------------------------

def _sim3_W(w: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """The Sim3 left-Jacobian-like matrix W(w, sigma) with t = W @ upsilon:
    W = C*I + A*hat(w) + B*hat(w)^2, with the standard sigma/theta
    small-value fallbacks (g2o sim3.h semantics)."""
    s = jnp.exp(sigma)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = _mm(W, W)
    sig_small = jnp.abs(sigma) < 1e-5
    th_small = theta2 < _EPS
    sigma_safe = jnp.where(sig_small, 1.0, sigma)
    # C coefficient (of I)
    C = jnp.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                  (s - 1.0) / sigma_safe)
    # theta-large branch
    a_ = s * jnp.sin(theta)
    b_ = s * jnp.cos(theta)
    c_ = theta2 + sigma * sigma
    c_safe = jnp.where(c_ < _EPS, 1.0, c_)
    A_big = (a_ * sigma + (1.0 - b_) * theta) / (theta * c_safe)
    B_big = (C - ((b_ - 1.0) * sigma + a_ * theta) / c_safe) / jnp.where(th_small, 1.0, theta2)
    # theta-small branch (sigma may be anything)
    sigma2_safe = jnp.where(sig_small, 1.0, sigma * sigma)
    A_small_sig = jnp.where(sig_small, 0.5, ((sigma - 1.0) * s + 1.0) / sigma2_safe)
    B_small_sig = jnp.where(
        sig_small, 1.0 / 6.0,
        ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0 - 0.5 * sigma * sigma)
        / (sigma2_safe * sigma_safe))
    A = jnp.where(th_small, A_small_sig, A_big)
    B = jnp.where(th_small, B_small_sig, B_big)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return C[..., None, None] * eye + A[..., None, None] * W \
        + B[..., None, None] * W2


def sim3_exp(xi: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Tangent [upsilon(3), omega(3), sigma(1)] -> (R, t, s).

    Closed form t = W(w, sigma) @ upsilon (behavioral twin of g2o's Sim3
    exponential used by OptimizeEssentialGraph)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return so3_exp(w), _mv(_sim3_W(w, sigma), v), jnp.exp(sigma)


def sim3_log(R: jnp.ndarray, t: jnp.ndarray, s) -> jnp.ndarray:
    """(R, t, s) -> tangent [upsilon(3), omega(3), sigma(1)]; the inverse of
    sim3_exp (g2o Sim3::log): w = so3_log(R), sigma = log(s), upsilon solves
    W(w, sigma) v = t (3x3 solve, batched)."""
    w = so3_log(R)
    sigma = jnp.log(jnp.asarray(s))
    Ws = _sim3_W(w, sigma)
    v = jnp.linalg.solve(Ws, t[..., None])[..., 0]
    return jnp.concatenate(
        [v, w, sigma[..., None]], axis=-1)


def sim3_apply(R: jnp.ndarray, t: jnp.ndarray, s, p: jnp.ndarray) -> jnp.ndarray:
    return jnp.asarray(s)[..., None] * _mv(R, p) + t


def sim3_inverse(R, t, s):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return Rt, -jnp.asarray(s_inv)[..., None] * _mv(Rt, t), s_inv


def sim3_compose(R1, t1, s1, R2, t2, s2):
    """(R1,t1,s1) o (R2,t2,s2): apply 2 first, then 1."""
    R = _mm(R1, R2)
    t = jnp.asarray(s1)[..., None] * _mv(R1, t2) + t1
    return R, t, s1 * s2


# ----------------------------------------------------------------------------
# Quaternions (for TUM trajectory export; reference Converter.cc:128-151)
# ----------------------------------------------------------------------------

def mat_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion [qx, qy, qz, qw] (TUM order), branch-free.

    Uses the 4-candidate construction and picks the best-conditioned one.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw2 = jnp.maximum(0.0, 1.0 + m00 + m11 + m22)
    qx2 = jnp.maximum(0.0, 1.0 + m00 - m11 - m22)
    qy2 = jnp.maximum(0.0, 1.0 - m00 + m11 - m22)
    qz2 = jnp.maximum(0.0, 1.0 - m00 - m11 + m22)
    cands = jnp.stack([
        jnp.stack([qx2, m01 + m10, m02 + m20, m21 - m12], axis=-1),
        jnp.stack([m01 + m10, qy2, m12 + m21, m02 - m20], axis=-1),
        jnp.stack([m02 + m20, m12 + m21, qz2, m10 - m01], axis=-1),
        jnp.stack([m21 - m12, m02 - m20, m10 - m01, qw2], axis=-1),
    ], axis=-2)  # [..., 4 candidates, 4 components]
    mags = jnp.stack([qx2, qy2, qz2, qw2], axis=-1)
    best = jnp.argmax(mags, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    # Canonicalize sign: qw >= 0
    return q * jnp.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion [qx, qy, qz, qw] -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = jnp.where(n > _EPS, 2.0 / n, 0.0)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return jnp.stack([
        jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
        jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
        jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
    ], axis=-2)


def rotm_to_euler(R: jnp.ndarray) -> jnp.ndarray:
    """XYZ Euler angles, matching the reference's `rotm2euler`
    (Geometry.cc:1003-1031) used for reference-frame selection."""
    sy = jnp.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = jnp.where(singular, jnp.arctan2(-R[..., 1, 2], R[..., 1, 1]),
                  jnp.arctan2(R[..., 2, 1], R[..., 2, 2]))
    y = jnp.arctan2(-R[..., 2, 0], sy)
    z = jnp.where(singular, jnp.zeros_like(sy), jnp.arctan2(R[..., 1, 0], R[..., 0, 0]))
    return jnp.stack([x, y, z], axis=-1)
