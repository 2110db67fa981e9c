"""Evaluation harness — the executable form of BASELINE configs 1-4.

The reference evaluates externally with the TUM benchmark tools
(reference workflow README.md:30-44: run rgbd_tum, then
evaluate_ate.py/evaluate_rpe.py against groundtruth.txt); here the whole
loop is one entry point:

    python -m gdslam_tpu.cli.evaluate SEQ_DIR ASSOC GROUNDTRUTH \
        [--mode plain|geometry|gd] [--settings TUM.yaml] [--masks DIR] \
        [--ref-masks DIR] [--vocab default|none|PATH] [--max-frames N] \
        [--segmenter flax[:WEIGHTS]]

Runs the selected pipeline over the sequence, associates the estimated
trajectory to ground truth by timestamp (nearest neighbour within 20 ms,
the TUM tools' default), and prints ATE RMSE + RPE plus a machine-readable
JSON line. With --ref-masks it additionally reports the mean IoU of the
refined dynamic masks against reference mask images (BASELINE's mask-IoU
metric for the GD/geometry modes).

Modes (BASELINE.md configs):
  plain    — config 1: no dynamic masking (TrackRGBD, System.cc:157)
  geometry — config 2: DynaSLAM multi-view geometric masking
             (4-arg GrabImageRGBD, Tracking.cc:331-369)
  gd       — config 3/4: GD dense-scene-flow masking (TrackRGBD_GD,
             Tracking.cc:212-269); --masks adds the semantic prior
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _associate(est_ts: np.ndarray, gt_ts: np.ndarray, max_dt: float = 0.02):
    """Index pairs (i_est, i_gt) of nearest-timestamp matches within max_dt
    (the TUM associate.py rule)."""
    pairs = []
    j = 0
    for i, t in enumerate(est_ts):
        j = int(np.searchsorted(gt_ts, t))
        best, best_dt = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(gt_ts) and abs(gt_ts[k] - t) <= best_dt:
                best, best_dt = k, abs(gt_ts[k] - t)
        if best >= 0:
            pairs.append((i, best))
    return pairs


def _mask_iou(est_mask: np.ndarray, ref_mask: np.ndarray) -> float:
    """IoU of the DYNAMIC region (mask==0 is dynamic in the 1=static
    convention used throughout; reference masks store dynamic=nonzero)."""
    dyn_e = est_mask < 0.5
    dyn_r = ref_mask > 0.5
    inter = float(np.sum(dyn_e & dyn_r))
    union = float(np.sum(dyn_e | dyn_r))
    return inter / union if union > 0 else 1.0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="gdslam_tpu.cli.evaluate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("seq_dir")
    ap.add_argument("assoc")
    ap.add_argument("groundtruth")
    ap.add_argument("--mode", choices=("plain", "geometry", "gd"),
                    default="plain")
    ap.add_argument("--settings", default=None,
                    help="OpenCV-YAML settings (default: TUM3-like intrinsics)")
    ap.add_argument("--masks", default=None,
                    help="semantic-mask cache dir (MaskNet protocol)")
    ap.add_argument("--ref-masks", default=None,
                    help="reference dynamic-mask dir ({ts}.png) for mask IoU")
    ap.add_argument("--vocab", default="none")
    ap.add_argument("--segmenter", default=None,
                    help="live segmenter spec: flax[:weights.npz|:coco.h5] "
                         "(runs on every mask-cache miss, MaskNet.cc:86-93)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--rpe-delta", type=int, default=30,
                    help="RPE frame spacing (default 30 = 1 s at 30 fps)")
    args = ap.parse_args(argv)

    from gdslam_tpu.config import SlamConfig
    from gdslam_tpu.io.tum import TumSequence
    from gdslam_tpu.system import trajectory as traj
    from gdslam_tpu.system.slam import Sensor, System
    from gdslam_tpu.utils import metrics

    if args.settings:
        cfg = SlamConfig.from_opencv_yaml(args.settings)
    else:
        cfg = SlamConfig()

    vocab = None
    if args.vocab == "default":
        from gdslam_tpu.backend import vocabulary as voc
        vocab = voc.default_vocabulary()
    elif args.vocab not in ("none", "-"):
        from gdslam_tpu.backend import vocabulary as voc
        vocab = voc.load(args.vocab)

    segmenter = None
    if args.masks or args.segmenter:
        from gdslam_tpu.masking.masknet import SegmentDynObject
        net = None
        if args.segmenter:
            from gdslam_tpu.models.maskrcnn import build_segmenter
            net = build_segmenter(
                args.segmenter,
                image_hw=(cfg.camera.height, cfg.camera.width))
        segmenter = SegmentDynObject(net, cache_dir=args.masks)

    slam = System(cfg, Sensor.RGBD, vocabulary=vocab, pipeline=True)
    seq = TumSequence(args.seq_dir, args.assoc, cfg.camera.depth_map_factor)
    n = len(seq) if args.max_frames is None else min(len(seq),
                                                     args.max_frames)
    ious = []
    for i in range(n):
        rgb, depth, ts = seq[i]
        mask = None
        if segmenter is not None:
            dyn = segmenter.get_segmentation(rgb, f"{ts:.6f}")
            mask = 1.0 - dyn
        if args.mode == "gd":
            # Host-side grayscale feeds the GD fast path a single-channel
            # uint8 frame: 3x fewer bytes to upload than rgb (921 KB ->
            # 307 KB). The GD path needs no color (gray flow + depth); rgb
            # is only required for inpaint outputs, which evaluate never
            # produces.
            g8 = rgb if rgb.ndim == 2 else (
                rgb.astype(np.float32) @ np.array(
                    [0.299, 0.587, 0.114], np.float32)).astype(np.uint8)
            # uint16 sensor units: triggers the single-buffer packed
            # upload in the GD fast path (numerically identical — the
            # on-disk PNG was uint16 in these units)
            d16 = depth if depth.dtype == np.uint16 else np.clip(
                depth * cfg.camera.depth_map_factor, 0, 65535
            ).astype(np.uint16)
            _, refined = slam.track_rgbd_gd(g8, d16, mask, ts)
        elif args.mode == "geometry":
            slam.track_rgbd(rgb, depth, mask, ts, use_geometry=True)
            refined = slam._last_refined_mask
        else:
            slam.track_rgbd(rgb, depth, mask, ts)
            refined = None
        if args.ref_masks and refined is not None:
            from PIL import Image
            p = os.path.join(args.ref_masks, f"{ts:.6f}.png")
            if os.path.exists(p):
                ref = np.asarray(Image.open(p), np.float32)
                if ref.ndim == 3:
                    ref = ref[..., 0]
                ious.append(_mask_iou(np.asarray(refined), ref / 255.0
                                      if ref.max() > 1 else ref))
        if i % 100 == 0:
            print(f"frame {i}/{n} state={slam.tracking_state.name} "
                  f"kfs={slam.keyframe_count}", file=sys.stderr)
    slam.shutdown()

    est = slam.tracker.camera_trajectory()   # [(ts, T_wc)]
    gt = traj.load_tum(args.groundtruth)     # [(ts, T_wc)]
    if not est:
        print(json.dumps({"error": "no tracked frames"}))
        return 1
    est_ts = np.array([t for t, _ in est])
    gt_ts = np.array([t for t, _ in gt])
    pairs = _associate(est_ts, gt_ts)
    if len(pairs) < 2:
        print(json.dumps({"error": "no timestamp associations with "
                          "groundtruth", "est_frames": len(est)}))
        return 1
    est_T = np.stack([est[i][1] for i, _ in pairs])
    gt_T = np.stack([gt[j][1] for _, j in pairs])
    ate = metrics.ate_rmse(est_T[:, :3, 3], gt_T[:, :3, 3])
    rpe = metrics.rpe_rmse(est_T, gt_T, delta=min(args.rpe_delta,
                                                  len(pairs) - 1))
    out = {"mode": args.mode, "frames": n, "tracked": len(est),
           "associated": len(pairs), "ate_rmse_m": round(ate, 5),
           "rpe_rmse_m": round(rpe, 5),
           "keyframes": slam.keyframe_count}
    if ious:
        out["mask_iou"] = round(float(np.mean(ious)), 4)
    print(f"ATE RMSE: {ate:.4f} m over {len(pairs)} associated frames")
    print(f"RPE RMSE: {rpe:.4f} m (delta={args.rpe_delta})")
    if ious:
        print(f"mask IoU: {np.mean(ious):.4f} over {len(ious)} frames")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
