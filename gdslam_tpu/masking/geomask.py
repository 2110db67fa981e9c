"""GeoMaskMaker: dense-scene-flow dynamic-object masking (the GD novelty).

Re-design of the reference GeoMaskMaker (include/GeoMaskMaker.h,
src/GeoMaskMaker.cc), implementing Alcantarilla et al. 2012 adapted to
RGB-D: pair frame t with frame t-5 (5-slot ring buffer, GeoMaskMaker.h:55,
cc:409-429), estimate their relative pose from feature matches
(GetRt, cc:77-156), compute dense optical flow (GetFlow, cc:158-166), and
flag pixels whose flow-warped 3D position disagrees with the rigid-motion
prediction by a large Mahalanobis distance (GetNoGMMmask, cc:167-326):

    d(p)      = X_cur(p + flow(p)) - (R * X_ref(p) + T)
    Sigma(p)  = J S J^T,  S = diag(sig_px^2 x4, depth_var(z_ref),
                                   depth_var(z_cur))
    depth_var = ((sigma/f) z^2)^2       (depth2std, cc:1386-1391, sigma=0.5)
    m(p)      = sqrt(d^T Sigma^-1 d)

then min-max-normalize m to [0,255] and threshold at 20 (static if below;
cc:276-326 — the masked Otsu scan the reference computes but discards is
available behind `use_otsu`). Depth gates 0 < z <= 3.5 (cc:229) and
depth-edge rejection (cc:198-199) are applied; frames with <20 pose-matches
degrade to an all-ones mask (cc:145-148), as do the first 5 frames
(cc:171-175).

The reference's per-pixel 640x480 C++ loop (its hottest code) becomes one
fused elementwise XLA program; the 3x3 covariance inverse is closed-form.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gdslam_tpu.backend import solvers
from gdslam_tpu.config import SlamConfig
from gdslam_tpu.core import camera as cam_ops
from gdslam_tpu.core import lie
from gdslam_tpu.frontend import extractor
from gdslam_tpu.ops import edges as edge_ops
from gdslam_tpu.ops import flow as flow_ops
from gdslam_tpu.ops import hamming, image as image_ops
from gdslam_tpu.ops import orb as orb_ops

_PREC = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnums=(4,))
def relative_pose(ref_gray, ref_depth, cur_gray, cur_depth, cfg: SlamConfig,
                  key=None):
    """GetRt (GeoMaskMaker.cc:77-156): ORB features on both frames, Hamming
    best matches, robust relative pose. With RGB-D depth on both sides the
    PnP RANSAC becomes a closed-form 3D-3D RANSAC battery (solvers.py).
    Returns (T_cur_ref [4,4], n_inliers)."""
    cam = cfg.camera
    if key is None:
        key = jax.random.PRNGKey(0)
    A = extractor.extract(ref_gray, cfg.orb, cam.height, cam.width)
    B = extractor.extract(cur_gray, cfg.orb, cam.height, cam.width)

    def kp_depth(depth, uv):
        u = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, cam.width - 1)
        v = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, cam.height - 1)
        return depth[v, u]

    zA = kp_depth(ref_depth, A.uv)
    zB = kp_depth(cur_depth, B.uv)
    D = hamming.hamming_matrix(orb_ops.descriptors_pm1(A.desc, A.valid),
                               orb_ops.descriptors_pm1(B.desc, B.valid))
    best, second, idx = hamming.best_two(D, axis=1)
    good = A.valid & (best < 64) & (zA > 0) & (zB[idx] > 0) & \
        (best.astype(jnp.float32) < 0.8 * second.astype(jnp.float32))
    # Keep the top-100 strongest matches (cc:117: top-100 by distance).
    order = jnp.argsort(jnp.where(good, best, 1 << 20))
    keep = jnp.zeros_like(good).at[order[:cfg.geomask.pnp_top_matches]].set(True)
    good = good & keep
    P = cam_ops.backproject(A.uv, zA, cam)
    Q = cam_ops.backproject(B.uv[idx], zB[idx], cam)
    res = solvers.ransac_rigid(P, Q, good, key, (cam.fx, cam.fy, cam.cx, cam.cy),
                               B.uv[idx], n_iters=300, min_inliers=20,
                               px_threshold=4.0)
    return res.T, res.n_inliers


@partial(jax.jit, static_argnums=(5, 6, 9))
def mahalanobis_mask(ref_depth, cur_depth, flow, T_cur_ref, sem_mask,
                     cfg: SlamConfig, use_otsu: bool = False,
                     ref_gray=None, cur_gray=None, flow_factor: int = 1):
    """GetNoGMMmask core (GeoMaskMaker.cc:167-326) as one fused program.

    The output mask is indexed by the *first* frame's pixel grid; `flow`
    maps first-frame pixels into the second frame and T_cur_ref maps
    first-frame camera coords into the second. The caller passes the
    CURRENT frame first (the reference indexes by the t-5 frame and applies
    the mask to frame t, accepting the object-motion misalignment; indexing
    by the current frame keeps the mask aligned with the frame it culls).

    Design: at production resolutions the whole program runs on a
    REDUCED grid (res_factor: /4 at >=480 rows, /2 at >=240) and the mask
    is upsampled at the end. The warp gathers + the ~100-op planar
    elementwise pipeline scale with the grid's pixel count (the H100 cost
    of each grid is ROADMAP A6); mask fidelity holds at the
    blob scale this masker feeds (keypoint culling + morphological open —
    a TUM-scale dynamic object spans >=10 px even on the quarter grid).
    Small test rigs (<240 rows) keep the full-res path.

    flow_factor: the factor at which `flow` is expressed — s means
    [H/s, W/s, 2] in /s-pixel units (farneback_flow(...,
    finest_level=log2(s), upsample=False)); 1 means a full-res flow which
    is subsampled here. Use `res_factor(cfg)` to pick the flow form.

    Returns (mask [H,W] float 1=static, dist_norm [H,W] in [0,255])."""
    import dataclasses
    cam = cfg.camera
    gcfg = cfg.geomask
    Hf, Wf = cam.height, cam.width
    s = res_factor(cfg)
    if s > 1:
        # Reduced grid: pixel (vh, uh) covers full-res pixel (s*vh, s*uh),
        # so (u_f - cx)/fx == (u_h - cx/s)/(fx/s): intrinsics divide by s.
        H, W = -(-Hf // s), -(-Wf // s)
        fx, fy, cx, cy = cam.fx / s, cam.fy / s, cam.cx / s, cam.cy / s
        cam_h = dataclasses.replace(cam, fx=fx, fy=fy, cx=cx, cy=cy,
                                    width=W, height=H)
        ref_depth = ref_depth[::s, ::s]  # nearest: never average true depths
        cur_depth = cur_depth[::s, ::s]  # across discontinuities
        if flow_factor == s:
            fl = flow
        else:
            assert flow_factor == 1, "flow must be full-res or at res_factor"
            fl = flow[::s, ::s] * (1.0 / s)
    else:
        H, W = Hf, Wf
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        cam_h = cam
        fl = flow
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)

    z_ref = ref_depth
    uv_cur = jnp.stack([u + fl[..., 0], v + fl[..., 1]], axis=-1)
    z_cur = image_ops.bilinear_sample(cur_depth, uv_cur)
    in_img = (uv_cur[..., 0] >= 0) & (uv_cur[..., 0] < W - 1) & \
             (uv_cur[..., 1] >= 0) & (uv_cur[..., 1] < H - 1)

    # Validity: depth gates (cc:229) + edge rejection on both frames
    # (cc:198-199, 224-228).
    ref_edges = edge_ops.depth_edges(ref_depth, cam_h)
    cur_edges = edge_ops.depth_edges(cur_depth, cam_h)
    cur_edge_at = image_ops.bilinear_sample(cur_edges.astype(jnp.float32),
                                            uv_cur) > 0.1
    valid = (z_ref > 0) & (z_ref <= gcfg.max_depth) & \
            (z_cur > 0) & (z_cur <= gcfg.max_depth) & \
            in_img & ~ref_edges & ~cur_edge_at
    if ref_gray is not None and cur_gray is not None:
        # Flow-quality gate: pixels whose warp is photometrically
        # inconsistent have unreliable flow; a wrong-flow Mahalanobis value
        # would otherwise dominate the normalization. On the reduced grid
        # the grays are s x s mean-pooled, NOT subsampled: aliased
        # [::s, ::s] texture fails this gate on ~40% of genuinely-dynamic
        # pixels (measured on the synthetic rig), gutting the mask.
        if s > 1:
            rg = _pool(ref_gray, Hf, Wf, s)
            cg = _pool(cur_gray, Hf, Wf, s)
        else:
            rg, cg = ref_gray, cur_gray
        warped = image_ops.bilinear_sample(cg, uv_cur)
        valid = valid & (jnp.abs(warped - rg) < 30.0)

    # Everything below runs PLANAR (structure-of-arrays: separate [H, W]
    # planes per vector/matrix component). Stacked [H, W, 3] / [H, W, 3, 3]
    # layouts put a 3-wide axis in the minor dimension, which vector units
    # use poorly.
    R, T = T_cur_ref[:3, :3], T_cur_ref[:3, 3]
    uc, vc = uv_cur[..., 0], uv_cur[..., 1]
    # back-projections, componentwise
    xr = (u - cx) / fx * z_ref
    yr = (v - cy) / fy * z_ref
    xc = (uc - cx) / fx * z_cur
    yc = (vc - cy) / fy * z_cur
    # d = X_cur - (R X_ref + T), R applied with scalar coefficients
    dx = xc - (R[0, 0] * xr + R[0, 1] * yr + R[0, 2] * z_ref + T[0])
    dy = yc - (R[1, 0] * xr + R[1, 1] * yr + R[1, 2] * z_ref + T[1])
    dz = z_cur - (R[2, 0] * xr + R[2, 1] * yr + R[2, 2] * z_ref + T[2])

    sigma = gcfg.depth_sigma
    # depth2std is a SENSOR model: it uses the physical focal length
    # regardless of the processing grid (halving f here would double the
    # modeled depth std and halve every z-dominated Mahalanobis distance).
    f_mean = 0.5 * (cam.fx + cam.fy)
    var_zc = ((sigma / f_mean) * z_cur * z_cur) ** 2   # depth2std^2 (cc:1386)
    var_zr = ((sigma / f_mean) * z_ref * z_ref) ** 2
    # 1 FULL-res pixel of keypoint/flow noise = 1/s reduced-grid pixels, so
    # the variance in grid units is 1/s^2 (the noise model is metric; only
    # the units changed with the reduced grid).
    sig_px = 1.0 / (s * s)

    def backproj_cov(uu, vv, z, var_z):
        """J S J^T for J = d(backproject)/d(u,v,z), S = diag(s,s,var_z):
        six unique components of the symmetric 3x3, as [H, W] planes."""
        gx = (uu - cx) / fx
        gy = (vv - cy) / fy
        zfx = z / fx
        zfy = z / fy
        m00 = sig_px * zfx * zfx + var_z * gx * gx
        m01 = var_z * gx * gy
        m02 = var_z * gx
        m11 = sig_px * zfy * zfy + var_z * gy * gy
        m12 = var_z * gy
        m22 = var_z
        return m00, m01, m02, m11, m12, m22

    a, b_, c, e, f_, i = backproj_cov(uc, vc, z_cur, var_zc)
    n00, n01, n02, n11, n12, n22 = backproj_cov(u, v, z_ref, var_zr)

    # Sig += R N R^T with N symmetric, R scalar: P = R N, then Sig += P R^T.
    def rotate_sym(n00, n01, n02, n11, n12, n22):
        out = []
        rows = ((R[0, 0], R[0, 1], R[0, 2]), (R[1, 0], R[1, 1], R[1, 2]),
                (R[2, 0], R[2, 1], R[2, 2]))
        P = [[rows[k][0] * n00 + rows[k][1] * n01 + rows[k][2] * n02,
              rows[k][0] * n01 + rows[k][1] * n11 + rows[k][2] * n12,
              rows[k][0] * n02 + rows[k][1] * n12 + rows[k][2] * n22]
             for k in range(3)]
        for (k, l) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
            out.append(P[k][0] * rows[l][0] + P[k][1] * rows[l][1]
                       + P[k][2] * rows[l][2])
        return out

    r00, r01, r02, r11, r12, r22 = rotate_sym(n00, n01, n02, n11, n12, n22)
    a = a + r00 + 1e-9
    b_ = b_ + r01
    c = c + r02
    e = e + r11 + 1e-9
    f_ = f_ + r12
    i = i + r22 + 1e-9
    det = a * (e * i - f_ * f_) - b_ * (b_ * i - f_ * c) + c * (b_ * f_ - e * c)
    det = jnp.where(jnp.abs(det) > 1e-18, det, 1e-18)
    i00 = (e * i - f_ * f_) / det
    i01 = (c * f_ - b_ * i) / det
    i02 = (b_ * f_ - c * e) / det
    i11 = (a * i - c * c) / det
    i12 = (b_ * c - a * f_) / det
    i22 = (a * e - b_ * b_) / det
    m2 = (dx * (i00 * dx + i01 * dy + i02 * dz)
          + dy * (i01 * dx + i11 * dy + i12 * dz)
          + dz * (i02 * dx + i12 * dy + i22 * dz))
    m = jnp.sqrt(jnp.maximum(m2, 0.0))
    m = jnp.where(valid, m, 0.0)
    # Materialize the distance map ONCE: without the barrier XLA fuses the
    # whole Mahalanobis pipeline into EACH downstream reduction (the
    # min/max/quantile passes), recomputing it ~12x.
    m, valid = jax.lax.optimization_barrier((m, valid))

    # Normalize over valid pixels -> [0, 255]. The reference min-max
    # normalizes (cc:276-277); a strict max is fragile (one bad-flow pixel
    # rescales the whole map), so the upper bound is the 99.5th percentile
    # of valid values, clipped — same intent, outlier-robust.
    m_min = jnp.min(jnp.where(valid, m, jnp.inf))
    m_min = jnp.where(jnp.isfinite(m_min), m_min, 0.0)
    # 99.5th percentile by bisection counting instead of a full sort of
    # the [H*W] map: 12 fused compare-reduce passes resolve
    # the quantile to max/4096, far below the normalization's sensitivity.
    n_valid = jnp.sum(valid).astype(jnp.float32)
    target = 0.995 * n_valid
    hi0 = jnp.max(jnp.where(valid, m, 0.0))

    def bisect(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum((m <= mid) & valid).astype(jnp.float32)
        below = cnt < target
        return jnp.where(below, mid, lo), jnp.where(below, hi, mid)

    lo, hi = jax.lax.fori_loop(0, 12, bisect, (m_min, hi0))
    m_max = jnp.maximum(0.5 * (lo + hi), m_min + 1e-6)
    dist = jnp.clip((m - m_min) / (m_max - m_min) * 255.0, 0.0, 255.0)
    dist = jnp.where(valid, dist, 0.0)

    if use_otsu:
        thr = _otsu_threshold(dist, valid)
    else:
        thr = gcfg.mahala_threshold          # fixed 20 (cc:278-326)
    # Two gates: the reference's normalized threshold, plus an absolute
    # Mahalanobis floor (in sigma units). Normalization alone flags the top
    # of the *noise* distribution on an all-static scene (the min-max
    # stretch guarantees large normalized values even when every raw
    # distance is statistically insignificant).
    dynamic = valid & (dist >= thr) & (m >= 15.0)
    # Morphological opening (erode then dilate) removes isolated bad-flow
    # false positives and closes the detected blob — the role the
    # reference's downstream DepthRegionGrowing + dilation plays
    # (Geometry.cc:415-450). Windows scale with the grid (same metric
    # extent as the full-res 5/7).
    from gdslam_tpu.frontend.frame import dilate_mask, erode_mask
    # s=4 dilates wider: the 2-px erode on the quarter grid removes a 2x
    # thicker metric boundary than half-res erode-3, which cost ~0.1 recall
    # on the synthetic guard; the extra dilation restores blob extent (the
    # reference over-dilates far more, 15 px at Geometry.cc:434-439).
    ke, kd = {1: (5, 7), 2: (3, 5), 4: (2, 5)}[s]
    dynamic = dilate_mask(erode_mask(dynamic, ke), kd)
    geo_static = 1.0 - dynamic.astype(jnp.float32)
    if s > 1:
        # Back to full resolution (nearest): the consumers are keypoint
        # culling and blob-level mask fusion, both insensitive to small
        # boundary quanta.
        geo_static = jnp.repeat(jnp.repeat(geo_static, s, 0), s, 1)[:Hf, :Wf]
        dist = jnp.repeat(jnp.repeat(dist, s, 0), s, 1)[:Hf, :Wf]
    return jnp.minimum(geo_static, sem_mask), dist


def res_factor(cfg: SlamConfig) -> int:
    """Downsample factor of the Mahalanobis grid: 4 at production
    resolutions (>=480 rows; a quarter of the half-res grid's pixels with
    no measurable mask-recall loss on the synthetic guard), 2 at medium
    (>=240), 1 on small test rigs where blobs would starve."""
    h = cfg.camera.height
    return 4 if h >= 480 else (2 if h >= 240 else 1)


def use_half_res(cfg: SlamConfig) -> bool:
    """Back-compat alias: whether the masker runs on a reduced grid."""
    return res_factor(cfg) > 1


def _pool(img, Hf: int, Wf: int, s: int):
    """s x s mean pool (antialiased reduced-res gray for the photometric
    gate)."""
    He, We = Hf - (Hf % s), Wf - (Wf % s)
    g = img[:He, :We].reshape(He // s, s, We // s, s).mean(axis=(1, 3))
    # pad back to ceil shape if the full-res dims were not divisible
    H, W = -(-Hf // s), -(-Wf // s)
    if g.shape != (H, W):
        g = jnp.pad(g, ((0, H - g.shape[0]), (0, W - g.shape[1])), mode="edge")
    return g


def _otsu_threshold(dist: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Masked Otsu scan over a 256-bin histogram (the reference computes this
    at cc:283-314 then discards it; kept behind the use_otsu flag)."""
    bins = jnp.clip(dist.astype(jnp.int32), 0, 255)
    hist = jnp.zeros(256).at[bins.reshape(-1)].add(valid.reshape(-1).astype(jnp.float32))
    total = jnp.maximum(jnp.sum(hist), 1.0)
    p = hist / total
    omega = jnp.cumsum(p)
    mu = jnp.cumsum(p * jnp.arange(256))
    mu_t = mu[-1]
    denom = omega * (1.0 - omega)
    sigma_b = jnp.where(denom > 1e-9, (mu_t * omega - mu) ** 2 / jnp.maximum(denom, 1e-9), 0.0)
    return jnp.argmax(sigma_b).astype(jnp.float32)


@partial(jax.jit, static_argnums=(7,))
def gd_step(cur_gray, cur_depth, sem_mask, ref_gray, ref_depth,
            ref_feats, key, cfg: SlamConfig):
    """Fused GD masking program: extract current features ONCE, estimate the
    cur->ref relative pose from (cached ref features x fresh cur features),
    run flow + the Mahalanobis map, and fall back to the semantic mask when
    pose matching is weak (<min_matches, GeoMaskMaker.cc:145-148) — all in
    one device program with no host round trips. Returns
    (cur_feats, refined_mask). The reference extracts THREE feature sets per
    GD frame (GetRt x2 + the frame rebuild); this path extracts one.
    """
    cam = cfg.camera
    feats = extractor.extract(cur_gray, cfg.orb, cam.height, cam.width)
    refined = gd_step_core(feats, cur_gray, cur_depth, sem_mask, ref_gray,
                           ref_depth, ref_feats, key, cfg)
    return feats, refined


def gd_step_core(feats, cur_gray, cur_depth, sem_mask, ref_gray, ref_depth,
                 ref_feats, key, cfg: SlamConfig):
    """gd_step body on PRE-EXTRACTED current features (shared with the
    batched per-slot tracker, which extracts once per frame for tracking
    anyway). Returns the refined static mask."""
    cam = cfg.camera

    def kp_depth(depth, uv):
        u = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, cam.width - 1)
        v = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, cam.height - 1)
        return depth[v, u]

    zA = kp_depth(cur_depth, feats.uv)
    zB = kp_depth(ref_depth, ref_feats.uv)
    D = hamming.hamming_matrix(orb_ops.descriptors_pm1(feats.desc, feats.valid),
                               orb_ops.descriptors_pm1(ref_feats.desc,
                                                       ref_feats.valid))
    best, second, idx = hamming.best_two(D, axis=1)
    good = feats.valid & (best < 64) & (zA > 0) & (zB[idx] > 0) & \
        (best.astype(jnp.float32) < 0.8 * second.astype(jnp.float32))
    order = jnp.argsort(jnp.where(good, best, 1 << 20))
    keep = jnp.zeros_like(good).at[
        order[:cfg.geomask.pnp_top_matches]].set(True)
    good = good & keep
    P = cam_ops.backproject(feats.uv, zA, cam)
    Q = cam_ops.backproject(ref_feats.uv[idx], zB[idx], cam)
    res = solvers.ransac_rigid(P, Q, good, key,
                               (cam.fx, cam.fy, cam.cx, cam.cy),
                               ref_feats.uv[idx], n_iters=300, min_inliers=20,
                               px_threshold=4.0)
    # reduced-resolution finest level, consumed at that factor directly by
    # the reduced-grid Mahalanobis program (see its docstring)
    s = res_factor(cfg)
    finest = {1: 0, 2: 1, 4: 2}[s]
    flow = flow_ops.farneback_flow(cur_gray, ref_gray, levels=5,
                                   finest_level=finest, upsample=(s == 1))
    mask, _ = mahalanobis_mask(cur_depth, ref_depth, flow, res.T, sem_mask,
                               cfg, cfg.geomask.use_otsu,
                               ref_gray=cur_gray, cur_gray=ref_gray,
                               flow_factor=s)
    pose_ok = res.n_inliers >= cfg.geomask.min_matches
    return jnp.where(pose_ok, mask, sem_mask)


class GeoMaskMaker:
    """Host wrapper with the 5-frame ring buffer (GeoMaskMaker.cc:409-429).

    Ring entries carry pre-extracted features so the relative-pose stage
    never re-extracts past frames."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.ring: list = []          # (gray, depth, feats) device arrays
        self.frame_count = 0
        self._key = jax.random.PRNGKey(7)
        self.last_feats = None        # current frame's extraction, reusable

    def add_new_image(self, gray, depth, sem_mask=None, feats=None):
        self.ring.append((gray, depth, feats))
        if len(self.ring) > self.cfg.geomask.inter_frame_size + 1:
            self.ring.pop(0)
        self.frame_count += 1

    # -- fused-dispatch support (System.track_rgbd_gd fast path) -----------
    @property
    def warm(self) -> bool:
        """True once get_mask would run the real masker for the NEXT frame
        (frame_count will exceed inter_frame_size after the push)."""
        return self.frame_count >= self.cfg.geomask.inter_frame_size

    def ref_for_next(self):
        """The ring entry that will be ring[0] (the t-5 pairing) after the
        next push — resolved BEFORE the push so the fused program can take
        it as an input. Ensures cached features exist (extracting here is
        rare: only entries inserted by the non-fused path lack them)."""
        idx = 1 if len(self.ring) > self.cfg.geomask.inter_frame_size else 0
        gray, depth, feats = self.ring[idx]
        if feats is None:
            cam = self.cfg.camera
            feats = extractor.extract(gray, self.cfg.orb,
                                      cam.height, cam.width)
            self.ring[idx] = (gray, depth, feats)
        return gray, depth, feats

    def push(self, gray, depth, feats):
        """Ring bookkeeping for a frame whose mask was computed by the fused
        program (add_new_image + the feature caching get_mask would do)."""
        self.ring.append((gray, depth, feats))
        if len(self.ring) > self.cfg.geomask.inter_frame_size + 1:
            self.ring.pop(0)
        self.frame_count += 1
        self.last_feats = feats

    def get_mask(self, sem_mask):
        """Refined static mask [H, W] float (1 = static)."""
        gcfg = self.cfg.geomask
        cur_gray, cur_depth, _ = self.ring[-1]
        if self.frame_count <= gcfg.inter_frame_size:
            # warm-up: all-pass (cc:171-175); still extract + cache features
            cam = self.cfg.camera
            self.last_feats = extractor.extract(cur_gray, self.cfg.orb,
                                                cam.height, cam.width)
            self.ring[-1] = (cur_gray, cur_depth, self.last_feats)
            return sem_mask
        ref_gray, ref_depth, ref_feats = self.ring[0]
        if ref_feats is None:
            cam = self.cfg.camera
            ref_feats = extractor.extract(ref_gray, self.cfg.orb,
                                          cam.height, cam.width)
            self.ring[0] = (ref_gray, ref_depth, ref_feats)
        self._key, k = jax.random.split(self._key)
        feats, refined = gd_step(cur_gray, cur_depth, sem_mask,
                                 ref_gray, ref_depth, ref_feats, k, self.cfg)
        self.last_feats = feats
        self.ring[-1] = (cur_gray, cur_depth, feats)
        return refined
