"""TUM RGB-D driver — the counterpart of Examples/RGB-D/rgbd_tum.cc.

Usage (positional, mirroring rgbd_tum.cc:30-33):

    python -m gdslam_tpu.cli.rgbd_tum VOCAB SETTINGS SEQUENCE_DIR ASSOC \
        [MASKS_DIR|no_save [OUTPUT_DIR]] [--segmenter flax[:WEIGHTS]]

- VOCAB: vocabulary .npz ('default' trains/loads the built-in one; 'none'
  disables loop closing + relocalization)
- SETTINGS: OpenCV-YAML camera/ORB settings (e.g. TUM3.yaml)
- MASKS_DIR: semantic-mask cache directory (the PATH_TO_MASKS protocol,
  rgbd_tum.cc:99-109; 'no_save' = use the segmenter without caching)
- OUTPUT_DIR: writes inpainted rgb/depth + refined masks (argc==7 mode,
  rgbd_tum.cc:165-171) and switches tracking to TrackRGBD_GD
- --segmenter: LIVE Flax Mask R-CNN run on every mask-cache miss (the
  reference's per-frame MaskNet inference, MaskNet.cc:86-93); WEIGHTS is a
  save_variables .npz or the reference's mask_rcnn_coco.h5. Fresh masks are
  written back to MASKS_DIR (unless 'no_save').

Emits CameraTrajectory.txt / KeyFrameTrajectory.txt (rgbd_tum.cc:203-204)
and prints median/mean tracking time (rgbd_tum.cc:192-200).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    seg_spec = None
    for i, a in enumerate(list(argv)):
        if a == "--segmenter" and i + 1 < len(argv):
            seg_spec = argv[i + 1]
            argv[i:i + 2] = []
            break
        if a.startswith("--segmenter="):
            seg_spec = a.split("=", 1)[1]
            argv.remove(a)
            break
    if len(argv) < 4:
        print(__doc__)
        return 1
    vocab_arg, settings_path, seq_dir, assoc_path = argv[:4]
    masks_dir = argv[4] if len(argv) > 4 else None
    output_dir = argv[5] if len(argv) > 5 else None

    from gdslam_tpu.config import SlamConfig
    from gdslam_tpu.masking.masknet import SegmentDynObject
    from gdslam_tpu.system.slam import Sensor, System

    cfg = SlamConfig.from_opencv_yaml(settings_path)
    vocab = None
    if vocab_arg == "default":
        from gdslam_tpu.backend import vocabulary as voc
        vocab = voc.default_vocabulary()
    elif vocab_arg not in ("none", "-"):
        from gdslam_tpu.backend import vocabulary as voc
        vocab = voc.load(vocab_arg)

    from gdslam_tpu.io import native_loader
    # raw=True: uint8 rgb + uint16 depth, 4x fewer bytes to upload than
    # float32; the System converts depth to float meters on device.
    seq = native_loader.NativeTumSequence(
        seq_dir, assoc_path, cfg.camera.depth_map_factor,
        cfg.camera.width, cfg.camera.height, raw=True)
    frames_iter = iter(seq)
    print(f"Loaded {len(seq)} frames from {seq_dir} (native prefetch)")

    net = None
    if seg_spec:
        from gdslam_tpu.models.maskrcnn import build_segmenter
        net = build_segmenter(seg_spec,
                              image_hw=(cfg.camera.height, cfg.camera.width))
    segmenter = SegmentDynObject(net, cache_dir=masks_dir) \
        if (masks_dir or net is not None) else None
    slam = System(cfg, Sensor.RGBD, vocabulary=vocab, pipeline=True)
    use_gd = output_dir is not None
    if output_dir:
        for sub in ("rgb", "depth", "mask"):
            os.makedirs(os.path.join(output_dir, sub), exist_ok=True)

    times = []
    for i, (rgb, depth, ts) in enumerate(frames_iter):
        mask = None
        if segmenter is not None:
            dyn = segmenter.get_segmentation(rgb, f"{ts:.6f}")
            mask = 1.0 - dyn                       # static=1 (rgbd_tum.cc:137-150)
        t0 = time.perf_counter()
        if use_gd:
            # argc==7 mode (rgbd_tum.cc:154): GD scene-flow masking with
            # inpainted rgb/depth outputs
            T, refined, rgb_o, depth_o = slam.track_rgbd_gd(
                rgb, depth, mask, ts, inpaint=True)
        elif segmenter is not None:
            # argc==6 mode (rgbd_tum.cc:157 -> GrabImageRGBD 4-arg,
            # Tracking.cc:331-369): DynaSLAM LightTrack + geometric correction
            T = slam.track_rgbd(rgb, depth, mask, ts, use_geometry=True)
        else:
            T = slam.track_rgbd(rgb, depth, mask, ts)
        times.append(time.perf_counter() - t0)
        if use_gd:
            from PIL import Image
            name = f"{ts:.6f}.png"
            Image.fromarray(rgb_o.astype(np.uint8)).save(
                os.path.join(output_dir, "rgb", name))
            Image.fromarray((depth_o * cfg.camera.depth_map_factor)
                            .astype(np.uint16)).save(
                os.path.join(output_dir, "depth", name))
            Image.fromarray((refined * 255).astype(np.uint8)).save(
                os.path.join(output_dir, "mask", name))
        if i % 50 == 0:
            print(f"frame {i}/{len(seq)} state={slam.tracking_state.name} "
                  f"kfs={slam.keyframe_count}")

    seq.close()
    slam.shutdown()
    times_s = sorted(times)
    print(f"median tracking time: {times_s[len(times_s)//2]:.4f}")
    print(f"mean tracking time: {sum(times)/len(times):.4f}")
    slam.save_trajectory_tum("CameraTrajectory.txt")
    slam.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    print("trajectory saved!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
