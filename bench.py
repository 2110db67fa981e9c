"""Benchmark: end-to-end tracked frames/sec on a CUDA GPU.

Prints JSON lines: {"metric", "value", "unit", "vs_baseline", "device"},
where "device" names JAX's platform, device kind and count and the card's
name and power limit. Exits with an error when JAX has no GPU.
Line 1: the plain tracking path (all-static masks, pipelined).
Line 2: the GD path (TrackRGBD_GD — dense scene-flow mask refinement before
tracking, Tracking.cc:212-269).

Baseline: the reference's implied real-time operating point is 30 fps camera
rate (BASELINE.md; reference rgbd_tum.cc:178-185 paces to camera rate) —
vs_baseline = fps / 30.
"""

import importlib.util
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def bench_tracking(frames, cfg):
    import jax
    import jax.numpy as jnp

    from gdslam_tpu.system.tracking import Tracking

    cam = cfg.camera
    ones = jnp.ones((cam.height, cam.width))
    tracker = Tracking(cfg, kmax=256, pmax=65536, pipeline=True)
    # One host sync per 6 frames keeps the state machine within the
    # reference's LocalMapping latency envelope (the CLI's cadence is 3;
    # timing what the CLI runs is ROADMAP A1).
    tracker.commit_every = 6
    # Warm-up must cover EVERY compile path: init, motion model, local map,
    # keyframe program with and without BA, and keyframe culling (first
    # triggered at the 8th keyframe) — a compile landing inside the timed
    # window wrecks the measurement.
    i = 0
    while i < len(frames) - 60 and len(tracker.kf_timestamps) < 10:
        tracker.process(frames[i].gray, frames[i].depth, ones, i / 30.0)
        i += 1
    tracker.flush()
    jax.block_until_ready(tracker.last.T_cw)

    n_frames = 60
    t0 = time.perf_counter()
    for k in range(i, i + n_frames):
        tracker.process(frames[k].gray, frames[k].depth, ones, k / 30.0)
    tracker.flush()
    jax.block_until_ready(tracker.last.T_cw)
    return n_frames / (time.perf_counter() - t0), tracker


def _mask_quality(refined_masks, frames, idxs):
    """(recall, iou) of the flagged-dynamic region vs the renderer's
    ground-truth dyn_mask, averaged over the sampled frames. Computed on
    frames OUTSIDE the timing windows (materializing a mask is a host sync,
    which would pollute the fps measurement)."""
    import numpy as np
    recalls, ious = [], []
    for m, k in zip(refined_masks, idxs):
        dyn_est = np.asarray(m) < 0.5
        dyn_gt = np.asarray(frames[k].dyn_mask)
        if dyn_gt.sum() == 0:
            continue
        inter = float((dyn_est & dyn_gt).sum())
        union = float((dyn_est | dyn_gt).sum())
        recalls.append(inter / dyn_gt.sum())
        ious.append(inter / union if union else 1.0)
    return (float(np.mean(recalls)) if recalls else 0.0,
            float(np.mean(ious)) if ious else 0.0)


def bench_gd(frames, cfg):
    """GD path on a DYNAMIC scene (the masker must do real work), with
    accuracy guards: ATE RMSE over the run + mask recall/IoU vs the
    renderer's ground truth on post-window frames."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gdslam_tpu.system.slam import System

    slam = System(cfg, pipeline=True)
    # Commit cadence 10 (vs the plain path's 6): fewer host syncs for the
    # ~2x larger GD program.
    slam.tracker.commit_every = 10
    # uint8 GRAY (converted on the host, a third of the rgb bytes) + uint16
    # raw depth, as cli/evaluate.py's GD mode feeds it.
    dmf = cfg.camera.depth_map_factor
    w3 = np.array([0.299, 0.587, 0.114], np.float32)
    raw = [((np.asarray(fr.rgb).astype(np.uint8).astype(np.float32) @ w3)
            .astype(np.uint8),
            (np.asarray(fr.depth) * dmf).astype(np.uint16))
           for fr in frames]
    # warm-up: cover every compile path incl. keyframe culling (8th KF)
    i = 0
    while i < len(frames) - 40 and slam.keyframe_count < 10:
        rgb, depth = raw[i]
        slam.track_rgbd_gd(rgb, depth, None, i / 30.0)
        i += 1
    slam.tracker.flush()
    jax.block_until_ready(slam.tracker.last.T_cw)

    # Median of 3 timing windows. main() renders enough frames that
    # warm-up (<=50) + 3x30 timed never reruns a frame.
    n_frames = 30
    fpss = []
    for _ in range(3):
        stop = min(i + n_frames, len(frames) - 10)
        t0 = time.perf_counter()
        for k in range(i, stop):
            rgb, depth = raw[k]
            slam.track_rgbd_gd(rgb, depth, None, k / 30.0)
        slam.tracker.flush()
        jax.block_until_ready(slam.tracker.last.T_cw)
        fpss.append((stop - i) / (time.perf_counter() - t0))
        i = stop
    # quality tail: masks materialized OUTSIDE the timing windows
    masks, idxs = [], []
    for k in range(i, min(i + 10, len(frames))):
        rgb, depth = raw[k]
        _, refined = slam.track_rgbd_gd(rgb, depth, None, k / 30.0)
        masks.append(refined)
        idxs.append(k)
    slam.tracker.flush()
    recall, iou = _mask_quality(masks, frames, idxs)
    ate = _plain_ate(slam.tracker.camera_trajectory())
    return sorted(fpss)[1], ate, recall, iou


def bench_geometry(frames, cfg):
    """The DynaSLAM geometry path (4-arg GrabImageRGBD, Tracking.cc:331-369)
    on a DYNAMIC scene: LightTrack pre-pass -> multi-view geometric mask
    correction -> Track, as one fused pipelined program. Guards: ATE RMSE +
    mask recall/IoU (post-window, like bench_gd)."""
    import jax
    import numpy as np

    from gdslam_tpu.system.slam import System

    slam = System(cfg, pipeline=True)
    slam.tracker.commit_every = 6
    i = 0
    while i < len(frames) - 40 and slam.keyframe_count < 8:
        slam.track_rgbd(frames[i].gray, frames[i].depth, None, i / 30.0,
                        use_geometry=True)
        i += 1
    slam.tracker.flush()
    jax.block_until_ready(slam.tracker.last.T_cw)
    n_frames = 30
    t0 = time.perf_counter()
    for k in range(i, i + n_frames):
        slam.track_rgbd(frames[k].gray, frames[k].depth, None, k / 30.0,
                        use_geometry=True)
    slam.tracker.flush()
    jax.block_until_ready(slam.tracker.last.T_cw)
    fps = n_frames / (time.perf_counter() - t0)
    i += n_frames
    masks, idxs = [], []
    for k in range(i, min(i + 10, len(frames))):
        slam.track_rgbd(frames[k].gray, frames[k].depth, None, k / 30.0,
                        use_geometry=True)
        masks.append(slam._last_refined_mask)
        idxs.append(k)
    slam.tracker.flush()
    recall, iou = _mask_quality(masks, frames, idxs)
    ate = _plain_ate(slam.tracker.camera_trajectory())
    return fps, ate, recall, iou


def bench_segmenter():
    """Full-resolution 480x640 Flax Mask R-CNN segmenter (the reference's
    per-frame MaskNet inference, MaskNet.cc:86-93), random weights."""
    import numpy as np

    from gdslam_tpu.models.maskrcnn import FlaxSegmenter

    seg = FlaxSegmenter(image_hw=(480, 640))
    rng = np.random.default_rng(0)
    # uint8 frames: the camera contract (4x fewer bytes than float32)
    ims = [rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)
           for _ in range(14)]
    _ = seg(ims[0])   # compile
    _ = seg(ims[1])
    # median of 3 windows
    fpss = []
    for w in range(3):
        t0 = time.perf_counter()
        for im in ims[2 + 4 * w:6 + 4 * w]:
            _ = seg(im)   # __call__ materializes the mask: true latency
        fpss.append(4 / (time.perf_counter() - t0))
    return sorted(fpss)[1]


def _plain_ate(slam_trajectory, n_skip=0):
    """ATE RMSE of a camera trajectory vs the synthetic ground truth."""
    import numpy as np

    from gdslam_tpu.io import synthetic
    from gdslam_tpu.utils import metrics

    est = slam_trajectory
    est_T = np.stack([T for _, T in est])
    gt_T = np.stack([np.linalg.inv(np.asarray(
        synthetic.gt_pose(round(ts * 30.0)))) for ts, _ in est])
    return metrics.ate_rmse(est_T[:, :3, 3], gt_T[:, :3, 3])


def main():
    from gdslam_tpu.config import SlamConfig
    from gdslam_tpu.io import synthetic
    from gdslam_tpu.utils import telemetry

    device = telemetry.gpu_device()

    cfg = SlamConfig()
    cam = cfg.camera
    frames = [synthetic.render_frame(i, cam, with_dynamic=False)
              for i in range(150)]
    # The GD/geometry benches run on a DYNAMIC scene: their maskers must do
    # real suppression work (an all-static scene would benchmark a no-op
    # mask and hide quality-gutting "optimizations").
    dyn_frames = [synthetic.render_frame(i, cam, with_dynamic=True)
                  for i in range(185)]

    fps, tracker = bench_tracking(frames, cfg)
    print(json.dumps({
        "metric": "tracked_frames_per_sec",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / 30.0, 3),
        "device": device,
        # accuracy guard alongside throughput: ATE RMSE vs the synthetic
        # ground truth over every frame the timed tracker saw
        "ate_rmse_m": round(_plain_ate(tracker.camera_trajectory()), 4),
    }), flush=True)

    # GD runs SECOND (a fresh-ish process state; running it after the
    # segmenter measurably depresses it) but its line prints LAST — the
    # driver records the final JSON line as the headline metric.
    fps_gd, ate_gd, rec_gd, iou_gd = bench_gd(dyn_frames, cfg)

    fps_geo, ate_geo, rec_geo, iou_geo = bench_geometry(dyn_frames, cfg)
    print(json.dumps({
        "metric": "geometry_tracked_frames_per_sec",
        "value": round(fps_geo, 2),
        "unit": "fps",
        "vs_baseline": round(fps_geo / 30.0, 3),
        "device": device,
        "ate_rmse_m": round(ate_geo, 4),
        "mask_recall": round(rec_geo, 3),
        "mask_iou": round(iou_geo, 3),
    }), flush=True)

    # the segmenter needs the optional flax extra
    if importlib.util.find_spec("flax") is not None:
        fps_seg = bench_segmenter()
        print(json.dumps({
            "metric": "seg_frames_per_sec",
            "value": round(fps_seg, 2),
            "unit": "fps",
            # no reference number exists for MaskNet inference; the pipeline
            # operating point (30 fps camera rate) is the only anchor
            "vs_baseline": round(fps_seg / 30.0, 3),
            "device": device,
        }), flush=True)

    print(json.dumps({
        "metric": "gd_tracked_frames_per_sec",
        "value": round(fps_gd, 2),
        "unit": "fps",
        "vs_baseline": round(fps_gd / 30.0, 3),
        "device": device,
        "ate_rmse_m": round(ate_gd, 4),
        "mask_recall": round(rec_gd, 3),
        "mask_iou": round(iou_gd, 3),
    }), flush=True)


if __name__ == "__main__":
    main()
