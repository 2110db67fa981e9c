"""Smoke test of GD-SLAM's main path on one CUDA GPU.

Runs the system through the entry points a user calls, at the TUM3
settings (`SlamConfig()`: 640x480, 1500 features, 8 pyramid levels):

  a. parity     ORB extraction, the pyramid resize, patch extraction,
                rBRIEF descriptors, Hamming distances and the GD mask on the
                GPU, against the same programs on the host CPU device and
                against numpy references;
  b. gd         `System.track_rgbd_gd` over rendered dynamic frames (uint8
                gray + uint16 depth), with ATE and mask recall/IoU gates;
  c. cli        `cli.rgbd_tum.main` in its argc==7 mode (mask cache + output
                directory: GD masking with inpainting) on a rendered
                TUM-layout sequence, with an ATE gate;
  d. plain, geometry   `System.track_rgbd` without and with geometric mask
                correction, with ATE gates;
  e. segmenter  the Flax Mask R-CNN with random weights; left out when the
                optional `flax` package is not installed.

`--four-cards` runs only the batched multi-sequence tracker
(`parallel.batch_eval`) over a 4-GPU mesh, and compares each slot with the
same sequence run alone on one card.

Every result line names the card and its power limit as nvidia-smi reports
them; the last line is one JSON object naming the JAX device. Without a GPU,
outside a checkout of the repository, or when any phase fails, the script
exits non-zero and prints no such line. Everything runs in this one process,
which holds the card.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Gates. Parity tolerances are GPU against the same program on the CPU
# device (or a numpy reference); PERF.md gives the reason for each.
KP_AGREEMENT_MIN = 0.98       # Jaccard of the valid keypoint sets
DESC_BIT_MISMATCH_MAX = 1e-3  # over keypoints present on both devices
RESIZE_ERR_MAX = 1e-2         # max |resize - float64 gather|, 0..255 scale
GD_MASK_DISAGREE_MAX = 0.01   # share of pixels whose GD mask differs
# Tracking gates, from the CPU test contracts: ATE as in
# tests/test_tracking_e2e.py, the CLI's as test_cli_e2e's masked run, mask
# recall as tests/test_live_segmenter_e2e.py. IoU has no CPU contract; the
# bound is half the full-resolution figure tests/test_masking.py quotes.
ATE_MAX_M = 0.06
CLI_ATE_MAX_M = 0.08
# tests/test_geometry_path.py only asks the geometry path to beat the
# unmasked one; 0.1 m is a breakage bound (a lost track drifts past it).
GEOMETRY_ATE_MAX_M = 0.1
MASK_RECALL_MIN = 0.3
MASK_IOU_MIN = 0.18
MIN_KEYFRAMES = 8             # keyframe culling first runs at the 8th
FOUR_CARD_POSE_ATOL = 5e-3    # as tests/test_multichip.py

N_GD_FRAMES = 120
N_CLI_FRAMES = 40
N_PLAIN_FRAMES = 30
N_FOUR_CARD_FRAMES = 30
TUM_T0 = 1305031790.0         # a TUM-like epoch timestamp


class SmokeFailure(RuntimeError):
    pass


def _fail(msg: str):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


class Reporter:
    """Prints one line per result, each prefixed by the card."""

    def __init__(self, card: str):
        self.card = card

    def line(self, phase: str, **values):
        body = " ".join(f"{k}={v}" for k, v in values.items())
        print(f"[{self.card}] {phase}: {body}", flush=True)

    def gate(self, phase: str, name: str, value, ok: bool, bound: str):
        self.line(phase, **{name: value, "bound": bound,
                            "pass": bool(ok)})
        if not ok:
            raise SmokeFailure(f"{phase}: {name}={value} fails {bound}")


# ----------------------------------------------------------------------------
# Rendered inputs
# ----------------------------------------------------------------------------

_FRAMES: dict = {}


def render_sequence(cam, frame_ids, with_dynamic=True):
    """Host-side frames as a camera delivers them: (rgb uint8, gray uint8,
    depth uint16 in sensor units, dyn_mask bool, T_wc) per frame.

    Each frame is rendered once per process. Dynamic scenes render on the
    default device; static ones on the CPU device, which compiles the
    renderer's other variant in seconds where the GPU takes over a minute
    (PERF.md)."""
    import jax
    import numpy as np

    from gdslam_tpu.io import synthetic
    w3 = np.array([0.299, 0.587, 0.114], np.float32)
    dev = jax.devices()[0] if with_dynamic else jax.devices("cpu")[0]
    out = []
    for i in frame_ids:
        key = (int(i), bool(with_dynamic), cam)
        if key not in _FRAMES:
            with jax.default_device(dev):
                fr = synthetic.render_frame(int(i), cam,
                                            with_dynamic=with_dynamic)
            rgb = np.asarray(fr.rgb).astype(np.uint8)
            gray = (rgb.astype(np.float32) @ w3).astype(np.uint8)
            depth = (np.asarray(fr.depth) * cam.depth_map_factor
                     ).astype(np.uint16)
            _FRAMES[key] = (rgb, gray, depth, np.asarray(fr.dyn_mask),
                            np.asarray(fr.T_wc))
        out.append(_FRAMES[key])
    return out


def trajectory_ate(trajectory, t0=0.0) -> float:
    """ATE RMSE (rigidly aligned) of (timestamp, T_wc) pairs against the
    renderer's ground truth at 30 fps."""
    import numpy as np

    from gdslam_tpu.io import synthetic
    from gdslam_tpu.utils import metrics
    est = np.stack([np.asarray(T)[:3, 3] for _, T in trajectory])
    gt = np.stack([np.asarray(synthetic.gt_pose(round((ts - t0) * 30.0)))
                   [:3, 3] for ts, _ in trajectory])
    return float(metrics.ate_rmse(est, gt))


def mask_quality(pairs):
    """Mean (recall, IoU) of the flagged-dynamic region (mask < 0.5)
    against the renderer's dyn_mask, over frames that show the object."""
    import numpy as np
    recalls, ious = [], []
    for refined, dyn_gt in pairs:
        dyn_est = np.asarray(refined) < 0.5
        if dyn_gt.sum() == 0:
            continue
        inter = float((dyn_est & dyn_gt).sum())
        union = float((dyn_est | dyn_gt).sum())
        recalls.append(inter / dyn_gt.sum())
        ious.append(inter / union)
    return float(np.mean(recalls)), float(np.mean(ious))


# ----------------------------------------------------------------------------
# numpy references
# ----------------------------------------------------------------------------

def resize_reference(img, out_h: int, out_w: int):
    """cv::resize INTER_LINEAR by direct gathers, in float64."""
    import numpy as np

    def axis(n_in, n_out):
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        x0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
        x1 = np.clip(x0 + 1, 0, n_in - 1)
        return x0, x1, np.clip(x - x0, 0.0, 1.0)

    img = np.asarray(img, np.float64)
    y0, y1, fy = axis(img.shape[0], out_h)
    x0, x1, fx = axis(img.shape[1], out_w)
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy)[:, None] + bot * fy[:, None]


def patches_reference(img, uv, size: int):
    """[K, size, size] patches centred at round(uv), zero outside."""
    import numpy as np
    img = np.asarray(img)
    H, W = img.shape
    half = size // 2
    u = np.round(np.asarray(uv)[:, 0]).astype(np.int64)
    v = np.round(np.asarray(uv)[:, 1]).astype(np.int64)
    rows = v[:, None] + np.arange(-half, half + 1)[None]
    cols = u[:, None] + np.arange(-half, half + 1)[None]
    ok = ((rows >= 0) & (rows < H))[:, :, None] & \
        ((cols >= 0) & (cols < W))[:, None, :]
    vals = img[np.clip(rows, 0, H - 1)[:, :, None],
               np.clip(cols, 0, W - 1)[:, None, :]]
    return np.where(ok, vals, 0).astype(img.dtype)


def hamming_reference(a, b):
    """[Na, Nb] Hamming distances of packed uint8 descriptors (popcount)."""
    import numpy as np
    lut = np.array([bin(i).count("1") for i in range(256)], np.int32)
    out = np.empty((a.shape[0], b.shape[0]), np.int32)
    for s in range(0, a.shape[0], 256):
        out[s:s + 256] = lut[a[s:s + 256, None, :] ^ b[None, :, :]].sum(-1)
    return out


# ----------------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------------

def _keyed(feats):
    """{(level, u, v): packed descriptor} over the valid keypoints."""
    import numpy as np
    uv = np.asarray(feats.uv)
    lvl = np.asarray(feats.level)
    desc = np.asarray(feats.desc)
    valid = np.asarray(feats.valid)
    return {(int(lvl[k]), int(round(uv[k, 0] * 64)), int(round(uv[k, 1] * 64))):
            desc[k] for k in np.flatnonzero(valid)}


def phase_parity(rep: Reporter, cfg, frames):
    """GPU against the CPU device and numpy on the same host inputs."""
    import jax
    import numpy as np

    from gdslam_tpu.frontend import extractor
    from gdslam_tpu.masking import geomask
    from gdslam_tpu.ops import hamming, image as image_ops, orb as orb_ops
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    cam = cfg.camera
    H, W = cam.height, cam.width

    def on(dev, *xs):
        return [jax.device_put(x, dev) for x in xs]

    # keypoints and descriptors, frame by frame
    inter = union = bits_diff = bits_total = 0
    for _, gray_u8, _, _, _ in frames:
        g = gray_u8.astype(np.float32)
        fg = extractor.extract(*on(gpu, g), cfg.orb, H, W)
        fc = extractor.extract(*on(cpu, g), cfg.orb, H, W)
        kg, kc = _keyed(fg), _keyed(fc)
        common = kg.keys() & kc.keys()
        inter += len(common)
        union += len(kg.keys() | kc.keys())
        for k in common:
            bits_diff += int(np.unpackbits(kg[k] ^ kc[k]).sum())
            bits_total += 256
    rep.gate("a.parity", "keypoint_agreement", round(inter / union, 6),
             inter / union >= KP_AGREEMENT_MIN, f">={KP_AGREEMENT_MIN}")
    mismatch = bits_diff / max(bits_total, 1)
    rep.gate("a.parity", "descriptor_bit_mismatch", mismatch,
             mismatch <= DESC_BIT_MISMATCH_MAX, f"<={DESC_BIT_MISMATCH_MAX}")

    # pyramid resize (level 0 -> 1) against a float64 gather reference
    g = frames[0][1].astype(np.float32)
    h1, w1 = image_ops.pyramid_shapes(H, W, 2, cfg.orb.scale_factor)[1]
    ref = resize_reference(g, h1, w1)
    errs = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        out = np.asarray(image_ops.resize_bilinear(*on(dev, g), h1, w1))
        errs[name] = float(np.abs(out - ref).max())
    rep.line("a.parity", resize_max_abs_err_cpu=errs["cpu"])
    rep.gate("a.parity", "resize_max_abs_err_gpu", errs["gpu"],
             errs["gpu"] <= RESIZE_ERR_MAX, f"<={RESIZE_ERR_MAX}")

    # patch extraction on the blurred level 0 at the GPU's keypoints
    blurred = np.asarray(image_ops.gaussian_blur(*on(cpu, g), 7, 2.0))
    uv = np.asarray(extractor.extract(*on(gpu, g), cfg.orb, H, W).uv)[:512]
    pg = np.asarray(orb_ops.extract_patches(*on(gpu, blurred, uv)))
    n_bad = int((pg != patches_reference(blurred, uv,
                                         orb_ops.PATCH_EXT)).sum())
    rep.gate("a.parity", "patch_values_not_exact", n_bad, n_bad == 0, "==0")

    # Hamming distances at the local-map matcher's shape
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (4096, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (1500, 32), dtype=np.uint8)
    ham = np.asarray(hamming.hamming_matrix(
        orb_ops.descriptors_pm1(jax.device_put(a, gpu)),
        orb_ops.descriptors_pm1(jax.device_put(b, gpu))))
    n_bad = int((ham != hamming_reference(a, b)).sum())
    rep.gate("a.parity", "hamming_4096x1500_not_exact", n_bad, n_bad == 0,
             "==0")

    # the GD mask: frame t paired with t-5, as the GD ring does
    (_, g_ref, d_ref, _, _), (_, g_cur, d_cur, _, _) = frames[-2], frames[-1]
    scale = 1.0 / cam.depth_map_factor
    inputs = (g_cur.astype(np.float32), d_cur.astype(np.float32) * scale,
              np.ones((H, W), np.float32), g_ref.astype(np.float32),
              d_ref.astype(np.float32) * scale)
    masks = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        cg, cd, sem, rg, rd = on(dev, *inputs)
        ref_feats = extractor.extract(rg, cfg.orb, H, W)
        key = jax.device_put(jax.random.PRNGKey(7), dev)
        _, m = geomask.gd_step(cg, cd, sem, rg, rd, ref_feats, key, cfg)
        masks[name] = np.asarray(m) < 0.5
    disagree = float((masks["gpu"] != masks["cpu"]).mean())
    rep.line("a.parity", gd_mask_dynamic_share_gpu=float(masks["gpu"].mean()),
             gd_mask_dynamic_share_cpu=float(masks["cpu"].mean()))
    rep.gate("a.parity", "gd_mask_disagreement", disagree,
             disagree <= GD_MASK_DISAGREE_MAX, f"<={GD_MASK_DISAGREE_MAX}")


def phase_gd(rep: Reporter, cfg, n_frames: int):
    """The GD RGB-D main path through `System`, host-fed frame by frame."""
    import numpy as np

    from gdslam_tpu.backend import vocabulary as voc
    from gdslam_tpu.system.slam import Sensor, System
    frames = render_sequence(cfg.camera, range(n_frames))
    slam = System(cfg, Sensor.RGBD, vocabulary=voc.default_vocabulary(),
                  pipeline=True)
    times, masks = [], []
    for i, (_, gray, depth, dyn, _) in enumerate(frames):
        t0 = time.perf_counter()
        _, refined = slam.track_rgbd_gd(gray, depth, None, i / 30.0)
        times.append(time.perf_counter() - t0)
        if i >= n_frames - 20:
            masks.append((refined, dyn))
    slam.shutdown()
    n_kf = slam.keyframe_count
    ate = trajectory_ate(slam.tracker.camera_trajectory())
    recall, iou = mask_quality(masks)
    steady = np.asarray(times[30:]) * 1e3
    rep.line("b.gd", frames=n_frames, keyframes=n_kf,
             map_points=slam.map_point_count,
             call_ms_median=round(float(np.median(steady)), 3),
             call_ms_p90=round(float(np.percentile(steady, 90)), 3))
    rep.gate("b.gd", "keyframes", n_kf, n_kf >= MIN_KEYFRAMES,
             f">={MIN_KEYFRAMES}")
    rep.gate("b.gd", "ate_rmse_m", round(ate, 5), ate < ATE_MAX_M,
             f"<{ATE_MAX_M}")
    rep.gate("b.gd", "mask_recall", round(recall, 4),
             recall > MASK_RECALL_MIN, f">{MASK_RECALL_MIN}")
    rep.gate("b.gd", "mask_iou", round(iou, 4), iou > MASK_IOU_MIN,
             f">{MASK_IOU_MIN}")


def write_tum_sequence(root: str, cfg, frames):
    """TUM layout: rgb/ and depth/ PNGs, masks/ (the segmenter's cache of
    dynamic masks), associations and OpenCV-YAML settings."""
    from PIL import Image
    for sub in ("rgb", "depth", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    assoc = []
    for i, (rgb, _, depth, dyn, _) in enumerate(frames):
        name = f"{TUM_T0 + i / 30.0:.6f}.png"
        Image.fromarray(rgb).save(os.path.join(root, "rgb", name))
        Image.fromarray(depth).save(os.path.join(root, "depth", name))
        Image.fromarray(dyn.astype("uint8") * 255).save(
            os.path.join(root, "masks", name))
        assoc.append(f"{name[:-4]} rgb/{name} {name[:-4]} depth/{name}")
    with open(os.path.join(root, "assoc.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    cam, orb = cfg.camera, cfg.orb
    settings = os.path.join(root, "settings.yaml")
    with open(settings, "w") as f:
        f.write("%YAML:1.0\n" + "".join(
            f"{k}: {v}\n" for k, v in (
                ("Camera.fx", cam.fx), ("Camera.fy", cam.fy),
                ("Camera.cx", cam.cx), ("Camera.cy", cam.cy),
                ("Camera.width", cam.width), ("Camera.height", cam.height),
                ("Camera.fps", cam.fps), ("Camera.bf", cam.bf),
                ("Camera.RGB", cam.rgb), ("ThDepth", cam.th_depth),
                ("DepthMapFactor", cam.depth_map_factor),
                ("ORBextractor.nFeatures", orb.n_features),
                ("ORBextractor.scaleFactor", orb.scale_factor),
                ("ORBextractor.nLevels", orb.n_levels),
                ("ORBextractor.iniThFAST", orb.ini_th_fast),
                ("ORBextractor.minThFAST", orb.min_th_fast))))
    return settings


def phase_cli(rep: Reporter, cfg, n_frames: int):
    """cli/rgbd_tum.main in process, argc==7 mode."""
    from gdslam_tpu.cli import rgbd_tum
    from gdslam_tpu.system import trajectory as traj
    frames = render_sequence(cfg.camera, range(n_frames))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "seq")
        out = os.path.join(tmp, "out")
        settings = write_tum_sequence(seq, cfg, frames)
        os.chdir(tmp)
        try:
            rc = rgbd_tum.main(["default", settings, seq,
                                os.path.join(seq, "assoc.txt"),
                                os.path.join(seq, "masks"), out])
        finally:
            os.chdir(cwd)
        if rc != 0:
            raise SmokeFailure(f"c.cli: rgbd_tum.main returned {rc}")
        est = traj.load_tum(os.path.join(tmp, "CameraTrajectory.txt"))
        n_out = {s: len(os.listdir(os.path.join(out, s)))
                 for s in ("rgb", "depth", "mask")}
    ate = trajectory_ate(est, t0=TUM_T0)
    rep.line("c.cli", frames=n_frames, trajectory_rows=len(est),
             **{f"written_{k}": v for k, v in n_out.items()})
    rep.gate("c.cli", "trajectory_rows", len(est), len(est) >= n_frames - 3,
             f">={n_frames - 3}")
    rep.gate("c.cli", "outputs_per_dir", min(n_out.values()),
             min(n_out.values()) == n_frames, f"=={n_frames}")
    rep.gate("c.cli", "ate_rmse_m", round(ate, 5), ate < CLI_ATE_MAX_M,
             f"<{CLI_ATE_MAX_M}")


def phase_plain_geometry(rep: Reporter, cfg, n_frames: int):
    """System.track_rgbd on a static scene, then with geometric mask
    correction on a dynamic one."""
    from gdslam_tpu.system.slam import System
    for name, dynamic, geometry, bound in (
            ("d.plain", False, False, ATE_MAX_M),
            ("d.geometry", True, True, GEOMETRY_ATE_MAX_M)):
        frames = render_sequence(cfg.camera, range(n_frames), dynamic)
        slam = System(cfg, pipeline=True)
        for i, (rgb, _, depth, _, _) in enumerate(frames):
            slam.track_rgbd(rgb, depth, None, i / 30.0,
                            use_geometry=geometry)
        slam.shutdown()
        ate = trajectory_ate(slam.tracker.camera_trajectory())
        rep.line(name, frames=n_frames, keyframes=slam.keyframe_count)
        rep.gate(name, "ate_rmse_m", round(ate, 5), ate < bound,
                 f"<{bound}")


def phase_segmenter(rep: Reporter, cfg):
    """Mask R-CNN with random weights: finite masks of the frame's shape."""
    import numpy as np

    from gdslam_tpu.models.maskrcnn import FlaxSegmenter
    cam = cfg.camera
    seg = FlaxSegmenter(image_hw=(cam.height, cam.width))
    for rgb, *_ in render_sequence(cam, range(3)):
        m = np.asarray(seg(rgb))
        ok = m.shape == (cam.height, cam.width) and bool(np.isfinite(m).all())
        rep.gate("e.segmenter", "mask_ok", ok, ok, "shape and finite")


def phase_four_cards(rep: Reporter, cfg, n_frames: int, n_cards: int = 4):
    """Batched GD tracker over an n-card mesh, one sequence per card, each
    slot compared with the same sequence run alone on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from jax.sharding import (NamedSharding, PartitionSpec as P,
                              SingleDeviceSharding)

    from gdslam_tpu.parallel import batch_eval
    devs = jax.devices()
    if len(devs) < n_cards:
        raise SmokeFailure(f"four-cards: {len(devs)} devices, need {n_cards}")
    cam = cfg.camera
    H, W = cam.height, cam.width
    kmax, pmax = 64, 8192
    mesh = batch_eval.make_mesh(n_cards)
    shard = NamedSharding(mesh, P("seq"))
    step = batch_eval.batched_track_step(cfg, H, W, mesh, kmax=kmax,
                                         pmax=pmax, local_batch=1)
    states = jax.device_put(batch_eval.init_states(
        n_cards, cfg, kmax=kmax, pmax=pmax, use_gd=True), shard)
    ones = jnp.ones((H, W))
    solo = jax.jit(lambda s, g, d: batch_eval.device_track_step(
        s, g, d, ones, cfg))
    solo_state = jax.device_put(batch_eval.init_seq_state(
        cfg, kmax=kmax, pmax=pmax, use_gd=True), devs[0])
    frames_b = jax.ShapeDtypeStruct((n_cards, H, W), jnp.float32,
                                    sharding=shard)
    frame_1 = jax.ShapeDtypeStruct((H, W), jnp.float32,
                                   sharding=SingleDeviceSharding(devs[0]))
    # compile the mesh program and the single-card one while the frames
    # render: XLA releases the GIL while it compiles
    with ThreadPoolExecutor(2) as ex:
        fut_b = ex.submit(lambda: step.lower(
            states, frames_b, frames_b).compile())
        fut_s = ex.submit(lambda: solo.lower(
            solo_state, frame_1, frame_1).compile())
        seqs = [render_sequence(cam, range(20 * b, 20 * b + n_frames))
                for b in range(n_cards)]
        step, solo = fut_b.result(), fut_s.result()
    scale = 1.0 / cam.depth_map_factor
    grays = np.stack([[f[1].astype(np.float32) for f in s] for s in seqs])
    depths = np.stack([[f[2].astype(np.float32) * scale for f in s]
                       for s in seqs])
    poses_b, times = [], []
    for t in range(n_frames):
        g, d = jax.device_put((grays[:, t], depths[:, t]), shard)
        t0 = time.perf_counter()
        states, _ = step(states, g, d)
        jax.block_until_ready(states.last_T_cw)
        times.append(time.perf_counter() - t0)
        poses_b.append(np.asarray(states.last_T_cw))
    # every card holds its own slot's state: count the bytes of each
    # device's shards over the whole state pytree
    held = {dv.id: 0 for dv in devs[:n_cards]}
    for leaf in jax.tree.leaves(states):
        for sh in leaf.addressable_shards:
            held[sh.device.id] = held.get(sh.device.id, 0) + sh.data.nbytes
    in_use = [(dv.memory_stats() or {}).get("bytes_in_use")
              for dv in devs[:n_cards]]
    rep.line("four_cards", state_bytes_per_card=list(held.values()),
             bytes_in_use_per_card=in_use,
             step_ms_median=round(float(np.median(times[5:])) * 1e3, 3))
    spread = len(held) == n_cards and min(held.values()) == max(held.values())
    rep.gate("four_cards", "state_spread_over_cards", spread, spread,
             f"equal state bytes on each of {n_cards} cards")

    worst = 0.0
    for b in range(n_cards):
        st = solo_state
        for t in range(n_frames):
            st, _ = solo(st, *jax.device_put((grays[b, t], depths[b, t]),
                                             devs[0]))
            worst = max(worst, float(np.abs(
                np.asarray(st.last_T_cw) - poses_b[t][b]).max()))
        n_kf_b, n_kf_s = int(states.arena.n_kf[b]), int(st.arena.n_kf)
        rep.line("four_cards", slot=b, keyframes_mesh=n_kf_b,
                 keyframes_alone=n_kf_s,
                 lost=bool(np.asarray(states.lost)[b]))
        if n_kf_b != n_kf_s or bool(np.asarray(states.lost)[b]):
            raise SmokeFailure(f"four_cards: slot {b} differs from its "
                               "single-card run or is lost")
    rep.gate("four_cards", "max_pose_diff_vs_alone", worst,
             worst <= FOUR_CARD_POSE_ATOL, f"<={FOUR_CARD_POSE_ATOL}")


# ----------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the batched tracker over a 4-GPU mesh")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "gdslam_tpu")):
        _fail("run from a checkout of the repository: no gdslam_tpu/ "
              f"beside {os.path.basename(__file__)}")
    sys.path.insert(0, HERE)
    # No GEMM autotuning unless the caller asks for it: it is 40-65 % of a
    # cold compile on the H100 (PERF.md), and this script claims no speed.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_autotune_level" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_gpu_autotune_level=0"
                                   ).strip()
    import jax

    from gdslam_tpu.utils import telemetry
    try:
        info = telemetry.gpu_device()
    except RuntimeError as e:
        _fail(f"{e}; this smoke test runs only on a CUDA GPU")
    n_cards = 4 if args.four_cards else 1
    cards = info["cards"][:n_cards]
    for line in cards:
        print(line, flush=True)
    rep = Reporter(" | ".join(cards))
    rep.line("device", platform=info["platform"], kind=repr(info["kind"]),
             count=info["count"], jax=jax.__version__)

    from gdslam_tpu.config import SlamConfig
    cfg = SlamConfig()
    t_all = time.perf_counter()
    if args.four_cards:
        phases = [("four_cards", lambda: phase_four_cards(
            rep, cfg, N_FOUR_CARD_FRAMES))]
    else:
        import importlib.util
        phases = [
            ("a.parity", lambda: phase_parity(
                rep, cfg, render_sequence(cfg.camera, (10, 15, 20)))),
            ("b.gd", lambda: phase_gd(rep, cfg, N_GD_FRAMES)),
            ("c.cli", lambda: phase_cli(rep, cfg, N_CLI_FRAMES)),
            ("d.plain_geometry", lambda: phase_plain_geometry(
                rep, cfg, N_PLAIN_FRAMES)),
        ]
        if importlib.util.find_spec("flax") is not None:
            phases.append(("e.segmenter", lambda: phase_segmenter(rep, cfg)))
        else:
            rep.line("e.segmenter", run=False,
                     reason="'flax' (the optional segmenter extra) is not "
                            "installed")
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        rep.line(name, wall_s=round(time.perf_counter() - t0, 3))
    rep.line("total", wall_s=round(time.perf_counter() - t_all, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
