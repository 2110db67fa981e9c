"""Per-stage timing of the hot per-frame programs on a CUDA GPU.

Measures wall time per call of each program in a tight loop on
device-resident inputs (block_until_ready at the end, divided by reps),
which is device time plus whatever dispatch does not overlap, for:
  - extractor.extract                    (the front-end)
  - matcher.match_candidates at M=4096, N=1500 (the local-map search shape)
  - tracking.track_step                  (plain path full per-frame program)
  - slam._gd_track_program               (GD path full per-frame program)
  - geomask gd_step pieces: flow levels, Mahalanobis

Every line names the card; the script exits with an error without a GPU.

Usage: python tools/profile_hot.py [reps]
"""

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np


CARD = ""


def timeit(name, fn, reps=20):
    out = fn()                       # compile
    jax.block_until_ready(out)
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps * 1e3
    print(f"[{CARD}] {name:42s} {dt:8.3f} ms")
    return dt


def main():
    global CARD
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    from gdslam_tpu.config import SlamConfig
    from gdslam_tpu.io import synthetic
    from gdslam_tpu.frontend import extractor, matcher
    from gdslam_tpu.ops import orb as orb_ops
    from gdslam_tpu.system.tracking import Tracking, track_step
    from gdslam_tpu.utils import telemetry

    CARD = " | ".join(telemetry.gpu_device()["cards"][:1])
    cfg = SlamConfig()
    cam = cfg.camera
    frames = [synthetic.render_frame(i, cam, with_dynamic=False)
              for i in range(12)]
    g0, d0 = frames[0].gray, frames[0].depth
    g1, d1 = frames[1].gray, frames[1].depth
    ones = jnp.ones((cam.height, cam.width))
    jax.block_until_ready((g0, d0, g1, d1))

    timeit("extract", lambda: extractor.extract(g1, cfg.orb, cam.height,
                                                cam.width), reps)

    # the dense matcher at the local-map search shape (cap x n_features)
    rng = np.random.default_rng(0)
    M, N = 4096, cfg.orb.n_features
    cand = (jnp.asarray(rng.uniform(0, cam.width, (M, 2)), jnp.float32),
            orb_ops.descriptors_pm1(jnp.asarray(
                rng.integers(0, 256, (M, 32), dtype=np.uint8))))
    kps = (jnp.asarray(rng.uniform(0, cam.width, (N, 2)), jnp.float32),
           orb_ops.descriptors_pm1(jnp.asarray(
               rng.integers(0, 256, (N, 32), dtype=np.uint8))))
    match = jax.jit(lambda c_uv, c_d, k_uv, k_d: matcher.match_candidates(
        c_uv, jnp.ones(M, bool), c_d, jnp.zeros(M, jnp.int32), jnp.zeros(M),
        jnp.full(M, 12.0), k_uv, jnp.ones(N, bool), k_d,
        jnp.zeros(N, jnp.int32), jnp.zeros(N), use_rotation=False,
        nn_ratio=0.8).point_idx)
    timeit(f"match_candidates M={M} N={N}",
           lambda: match(*cand, *kps), reps)

    # a live tracker to get a valid arena/last state
    tr = Tracking(cfg, kmax=256, pmax=65536, pipeline=False)
    for i, fr in enumerate(frames):
        tr.process(fr.gray, fr.depth, ones, i / 30.0)
    vel = tr.velocity if tr.velocity is not None else jnp.eye(4)
    has_vel = tr.velocity is not None

    timeit("track_step (full per-frame program)",
           lambda: track_step(tr.arena, tr.last, vel, jnp.asarray(has_vel),
                              g1, d1, ones, cfg, jnp.asarray(tr.ref_kf),
                              jnp.asarray(False)), reps)

    # GD program
    from gdslam_tpu.system.slam import System, _gd_track_program
    slam = System(cfg, pipeline=True)
    dmf = cam.depth_map_factor
    w3 = np.array([0.299, 0.587, 0.114], np.float32)
    raw = [((np.asarray(fr.rgb).astype(np.uint8).astype(np.float32) @ w3)
            .astype(np.uint8), (np.asarray(fr.depth) * dmf).astype(np.uint16))
           for fr in frames]
    for i in range(10):
        slam.track_rgbd_gd(raw[i][0], raw[i][1], None, i / 30.0)
    slam.tracker.flush()
    tr2 = slam.tracker
    geo = slam._geo
    if geo is not None and geo.warm and tr2.last is not None:
        ref_gray, ref_depth, ref_feats = geo.ref_for_next()
        sem = jnp.ones((cam.height, cam.width), jnp.float32)
        vel2 = tr2.velocity if tr2.velocity is not None else tr2._eye4
        rgb_u8 = jnp.asarray(raw[10][0])
        dep_u16 = jnp.asarray(raw[10][1])
        jax.block_until_ready((rgb_u8, dep_u16))
        timeit("_gd_track_program (full GD frame)",
               lambda: _gd_track_program(
                   tr2.arena, tr2.last, vel2, tr2._jbool(tr2.velocity is not None),
                   tr2._ref_kf_dev, tr2._jbool(False), rgb_u8, dep_u16, sem,
                   ref_gray, ref_depth, ref_feats, cfg, True, tr2.frame_id),
               reps)

        # flow alone
        from gdslam_tpu.ops import flow as flow_ops

        fl_fn = jax.jit(lambda a, b: flow_ops.farneback_flow(a, b))
        timeit("farneback_flow (default knobs)", lambda: fl_fn(g0, g1), reps)

        # --- GD stage breakdown on the same inputs the fused program sees
        from gdslam_tpu.masking import geomask
        from gdslam_tpu.backend import solvers as slv
        from gdslam_tpu.ops import hamming, orb as orb_ops
        cfg_ = cfg
        key = jax.random.PRNGKey(0)
        g1f = g1.astype(jnp.float32)
        g0f = g0.astype(jnp.float32)
        timeit("gd_step (extract+match+ransac+flow+mahal)",
               lambda: geomask.gd_step(g1f, d1, ones, ref_gray, ref_depth,
                                       ref_feats, key, cfg_), reps)
        s = geomask.res_factor(cfg_)
        finest = {1: 0, 2: 1, 4: 2}[s]
        fl_half = jax.jit(lambda a, b: flow_ops.farneback_flow(
            a, b, levels=5, finest_level=finest, upsample=(s == 1)))
        flw = fl_half(g1f, g0f)
        jax.block_until_ready(flw)
        timeit(f"  flow (levels=5, finest={finest})",
               lambda: fl_half(g1f, g0f), reps)
        timeit("  mahalanobis_mask",
               lambda: geomask.mahalanobis_mask(
                   d1, d0, flw, jnp.eye(4), ones, cfg_, False,
                   ref_gray=g1f, cur_gray=g0f, flow_factor=s), reps)

        feats1 = extractor.extract(g1f, cfg_.orb, cam.height, cam.width)
        jax.block_until_ready(feats1.uv)

        def match_ransac():
            A, B = feats1, ref_feats
            D = hamming.hamming_matrix(
                orb_ops.descriptors_pm1(A.desc, A.valid),
                orb_ops.descriptors_pm1(B.desc, B.valid))
            best, second, idx = hamming.best_two(D, axis=1)
            good = A.valid & (best < 64)
            from gdslam_tpu.core import camera as cam_ops2
            P = cam_ops2.backproject(A.uv, jnp.ones(A.uv.shape[0]), cam)
            Q = cam_ops2.backproject(B.uv[idx], jnp.ones(A.uv.shape[0]), cam)
            return slv.ransac_rigid(P, Q, good, key,
                                    (cam.fx, cam.fy, cam.cx, cam.cy),
                                    B.uv[idx], n_iters=300, min_inliers=20,
                                    px_threshold=4.0).T
        mr = jax.jit(match_ransac)
        timeit("  hamming match + ransac_rigid", lambda: mr(), reps)

        # track_frame_core alone (pre-built frame)
        from gdslam_tpu.frontend.frame import build_frame
        from gdslam_tpu.system.tracking import track_frame_core
        frame1 = build_frame(feats1, d1, ones, cam)
        jax.block_until_ready(frame1.uv)
        timeit("  track_frame_core (pre-built frame)",
               lambda: track_frame_core(tr2.arena, tr2.last, vel2,
                                        tr2._jbool(True), frame1, cfg_,
                                        tr2._ref_kf_dev, tr2._jbool(False)),
               reps)

        # pose_optimization alone
        from gdslam_tpu.backend import optimizer as opt_mod
        N = feats1.uv.shape[0]
        obs = opt_mod.PoseObs(
            pw=jnp.ones((N, 3)), uv=feats1.uv, ur=-jnp.ones(N),
            inv_sigma2=jnp.ones(N), valid=feats1.valid)
        po = jax.jit(lambda T: opt_mod.pose_optimization(
            T, obs, (cam.fx, cam.fy, cam.cx, cam.cy), cam.bf)[0])
        timeit("  pose_optimization (4x10 GN)", lambda: po(jnp.eye(4)), reps)

    # Device-resident GD throughput: the FULL GD system (fast path,
    # pipelined commits) on frames already in device memory — the per-frame
    # rate without the host->device upload that bench.py's host-fed number
    # includes. Uses a fresh tracker to keep the run self-contained.
    from gdslam_tpu.system.slam import System as _Sys
    frames_dyn = [synthetic.render_frame(i, cam, with_dynamic=True)
                  for i in range(110)]
    raw_dev = [(jnp.asarray((np.asarray(fr.rgb).astype(np.float32) @ w3)
                            .astype(np.uint8)),
                jnp.asarray((np.asarray(fr.depth) * dmf).astype(np.uint16)))
               for fr in frames_dyn]
    jax.block_until_ready(raw_dev)
    s2 = _Sys(cfg, pipeline=True)
    s2.tracker.commit_every = 10
    i2 = 0
    while i2 < len(frames_dyn) - 35 and s2.keyframe_count < 10:
        g, d = raw_dev[i2]
        s2.track_rgbd_gd(g, d, None, i2 / 30.0)
        i2 += 1
    s2.tracker.flush()
    jax.block_until_ready(s2.tracker.last.T_cw)
    t0 = time.perf_counter()
    n2 = 0
    for k in range(i2, len(frames_dyn)):
        g, d = raw_dev[k]
        s2.track_rgbd_gd(g, d, None, k / 30.0)
        n2 += 1
    s2.tracker.flush()
    jax.block_until_ready(s2.tracker.last.T_cw)
    print(f"[{CARD}] {'GD device-resident frames/sec':42s} "
          f"{n2 / (time.perf_counter() - t0):8.2f} fps")

    # host-side dispatch overhead: time N pipelined process() calls with
    # device-resident inputs (includes python + dispatch latency)
    tr3 = Tracking(cfg, kmax=256, pmax=65536, pipeline=True)
    tr3.commit_every = 6
    i = 0
    while i < len(frames) and len(tr3.kf_timestamps) < 4:
        tr3.process(frames[i].gray, frames[i].depth, ones, i / 30.0)
        i += 1
    tr3.flush()
    jax.block_until_ready(tr3.last.T_cw)
    t0 = time.perf_counter()
    n = 0
    for k in range(i, len(frames)):
        tr3.process(frames[k].gray, frames[k].depth, ones, k / 30.0)
        n += 1
    tr3.flush()
    jax.block_until_ready(tr3.last.T_cw)
    print(f"[{CARD}] {'pipelined process() wall/frame':42s} "
          f"{(time.perf_counter() - t0) / max(n, 1) * 1e3:8.2f} ms")


if __name__ == "__main__":
    main()
