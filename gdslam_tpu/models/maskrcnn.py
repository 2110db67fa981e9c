"""Flax Mask R-CNN for semantic dynamic-object masking.

Replaces the reference's embedded Python-2.7 Keras Mask R-CNN
(src/python/model.py:1640-2360, MaskRCNN.py, coco.py): ResNet50-FPN
backbone, RPN with fixed-budget proposal selection, ROIAlign as batched
bilinear crops, class/box/mask heads, and the `GetDynSeg` postprocessing —
the union of instance masks over the 20 movable COCO classes
(MaskRCNN.py:83-140) — as a single jitted program.

Design notes:
- All stages use fixed budgets (top-k pre/post NMS proposals, fixed
  detection count) so the whole network is one static-shape XLA program.
- NMS is a fixed-trip-count suppression loop (`lax.fori_loop`).
- COCO config matches the reference (81 classes, coco.py:63-84).
- Weights: `convert_keras_h5` maps the reference's `mask_rcnn_coco.h5`
  (not shipped in either repo) into this module's param tree; without it
  the model runs with random weights (architecture/shape tests only).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Sequence

try:
    import flax.linen as nn
except ModuleNotFoundError as e:   # flax is the optional `segmenter` extra
    raise ImportError(
        "the Mask R-CNN segmenter (gdslam_tpu.models.maskrcnn, "
        "--segmenter) needs the 'flax' package: pip install "
        "'gdslam-tpu[segmenter]'") from e
import jax
import jax.numpy as jnp
import numpy as np

NUM_CLASSES = 81  # COCO + background (reference coco.py:63-84)

# Movable COCO classes whose instances are masked as dynamic — the EXACT
# 19-class union of reference MaskRCNN.py:83-146 (person..boat are COCO ids
# 1-9; bird..giraffe are ids 15-24; ids 10-14 — traffic light, fire hydrant,
# stop sign, parking meter, bench — are static and NOT masked).
DYNAMIC_CLASS_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe")
DYNAMIC_CLASS_IDS = tuple(range(1, 10)) + tuple(range(15, 25))

# Box-regression target normalization (reference config.py BBOX_STD_DEV /
# RPN_BBOX_STD_DEV = [0.1, 0.1, 0.2, 0.2]).
BBOX_STD = np.asarray([0.1, 0.1, 0.2, 0.2], np.float32)


class Bottleneck(nn.Module):
    filters: int
    strides: int = 1
    projection: bool = False

    @nn.compact
    def __call__(self, x, train: bool = False):
        # train=True computes batch statistics and ASSIGNS them to the
        # running stats (momentum 0) — used only by calibrate_batch_stats;
        # training itself runs frozen-BN like the reference (TRAIN_BN=False,
        # model.py:1929 comment), whose pretrained h5 carries good stats.
        def bn(v):
            return nn.BatchNorm(use_running_average=not train,
                                momentum=0.0, epsilon=1e-3)(v)
        residual = x
        y = nn.Conv(self.filters, (1, 1), strides=(self.strides,) * 2,
                    use_bias=False)(x)
        y = nn.relu(bn(y))
        y = nn.Conv(self.filters, (3, 3), padding="SAME", use_bias=False)(y)
        y = nn.relu(bn(y))
        y = nn.Conv(self.filters * 4, (1, 1), use_bias=False)(y)
        y = bn(y)
        if self.projection:
            residual = nn.Conv(self.filters * 4, (1, 1),
                               strides=(self.strides,) * 2, use_bias=False)(x)
            residual = bn(residual)
        return nn.relu(y + residual)


class ResNetFPN(nn.Module):
    """ResNet50 C2-C5 + FPN P2-P6 (model.py resnet_graph + fpn)."""

    blocks: Sequence[int] = (3, 4, 6, 3)
    fpn_dim: int = 256

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = nn.Conv(64, (7, 7), strides=(2, 2), padding=[(3, 3), (3, 3)],
                    use_bias=False)(x)
        x = nn.BatchNorm(use_running_average=not train, momentum=0.0,
                         epsilon=1e-3)(x)
        x = nn.relu(x)
        x = nn.max_pool(x, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)])
        cs = []
        for i, n_block in enumerate(self.blocks):
            filters = 64 * (2 ** i)
            stride = 1 if i == 0 else 2
            x = Bottleneck(filters, strides=stride, projection=True)(x, train)
            for _ in range(n_block - 1):
                x = Bottleneck(filters)(x, train)
            cs.append(x)
        c2, c3, c4, c5 = cs
        p5 = nn.Conv(self.fpn_dim, (1, 1))(c5)
        p4 = nn.Conv(self.fpn_dim, (1, 1))(c4) + jax.image.resize(
            p5, (p5.shape[0], c4.shape[1], c4.shape[2], self.fpn_dim), "nearest")
        p3 = nn.Conv(self.fpn_dim, (1, 1))(c3) + jax.image.resize(
            p4, (p4.shape[0], c3.shape[1], c3.shape[2], self.fpn_dim), "nearest")
        p2 = nn.Conv(self.fpn_dim, (1, 1))(c2) + jax.image.resize(
            p3, (p3.shape[0], c2.shape[1], c2.shape[2], self.fpn_dim), "nearest")
        p2 = nn.Conv(self.fpn_dim, (3, 3), padding="SAME")(p2)
        p3 = nn.Conv(self.fpn_dim, (3, 3), padding="SAME")(p3)
        p4 = nn.Conv(self.fpn_dim, (3, 3), padding="SAME")(p4)
        p5 = nn.Conv(self.fpn_dim, (3, 3), padding="SAME")(p5)
        p6 = nn.max_pool(p5, (1, 1), strides=(2, 2))
        return [p2, p3, p4, p5, p6]


class RPNHead(nn.Module):
    anchors_per_loc: int = 3

    @nn.compact
    def __call__(self, feat):
        shared = nn.relu(nn.Conv(512, (3, 3), padding="SAME")(feat))
        logits = nn.Conv(self.anchors_per_loc, (1, 1))(shared)
        deltas = nn.Conv(self.anchors_per_loc * 4, (1, 1))(shared)
        B, H, W, _ = feat.shape
        return (logits.reshape(B, -1), deltas.reshape(B, -1, 4))


class BoxHead(nn.Module):
    @nn.compact
    def __call__(self, rois):  # [R, 7, 7, C]
        x = rois.reshape(rois.shape[0], -1)
        x = nn.relu(nn.Dense(1024)(x))
        x = nn.relu(nn.Dense(1024)(x))
        cls = nn.Dense(NUM_CLASSES)(x)
        box = nn.Dense(NUM_CLASSES * 4)(x).reshape(-1, NUM_CLASSES, 4)
        return cls, box


class MaskHead(nn.Module):
    @nn.compact
    def __call__(self, rois):  # [R, 14, 14, C]
        x = rois
        for _ in range(4):
            x = nn.relu(nn.Conv(256, (3, 3), padding="SAME")(x))
        x = nn.relu(nn.ConvTranspose(256, (2, 2), strides=(2, 2))(x))
        return nn.Conv(NUM_CLASSES, (1, 1))(x)      # [R, 28, 28, classes]


# ----------------------------------------------------------------------------
# Anchors, boxes, NMS, ROIAlign — functional pieces (utils.py equivalents)
# ----------------------------------------------------------------------------

def generate_anchors(image_hw: tuple, strides=(4, 8, 16, 32, 64),
                     scales=(32, 64, 128, 256, 512),
                     ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """[A, 4] anchors (y1, x1, y2, x2) over all FPN levels.

    Ordering contract: location-major with `ratios` innermost —
    (level, y, x, ratio) — matching the RPN head's [B, H, W, A] -> [B, -1]
    reshape so anchors[i] pairs with logits[i]."""
    H, W = image_hw
    out = []
    for stride, scale in zip(strides, scales):
        fh, fw = int(np.ceil(H / stride)), int(np.ceil(W / stride))
        cy = (np.arange(fh) + 0.5) * stride
        cx = (np.arange(fw) + 0.5) * stride
        cy, cx = np.meshgrid(cy, cx, indexing="ij")
        per_ratio = []
        for r in ratios:
            h = scale / np.sqrt(r)
            w = scale * np.sqrt(r)
            per_ratio.append(np.stack([cy - h / 2, cx - w / 2,
                                       cy + h / 2, cx + w / 2], -1))
        # [fh, fw, R, 4] -> location-major, ratio innermost
        out.append(np.stack(per_ratio, axis=2).reshape(-1, 4))
    return np.concatenate(out, 0).astype(np.float32)


def apply_deltas(boxes: jnp.ndarray, deltas: jnp.ndarray) -> jnp.ndarray:
    """Standard (dy, dx, log dh, log dw) box regression."""
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    cy = boxes[:, 0] + 0.5 * h
    cx = boxes[:, 1] + 0.5 * w
    cy = cy + deltas[:, 0] * h
    cx = cx + deltas[:, 1] * w
    h = h * jnp.exp(jnp.clip(deltas[:, 2], -4, 4))
    w = w * jnp.exp(jnp.clip(deltas[:, 3], -4, 4))
    return jnp.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)


def box_iou(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """[Na, Nb] IoU matrix."""
    y1 = jnp.maximum(a[:, None, 0], b[None, :, 0])
    x1 = jnp.maximum(a[:, None, 1], b[None, :, 1])
    y2 = jnp.minimum(a[:, None, 2], b[None, :, 2])
    x2 = jnp.minimum(a[:, None, 3], b[None, :, 3])
    inter = jnp.maximum(y2 - y1, 0) * jnp.maximum(x2 - x1, 0)
    area_a = jnp.maximum(a[:, 2] - a[:, 0], 0) * jnp.maximum(a[:, 3] - a[:, 1], 0)
    area_b = jnp.maximum(b[:, 2] - b[:, 0], 0) * jnp.maximum(b[:, 3] - b[:, 1], 0)
    return inter / jnp.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def nms_fixed(boxes: jnp.ndarray, scores: jnp.ndarray, iou_th: float,
              n_out: int):
    """Fixed-budget NMS: returns indices [n_out] (-1 padded)."""
    iou = box_iou(boxes, boxes)

    def body(i, state):
        alive, picked = state
        best = jnp.argmax(jnp.where(alive, scores, -jnp.inf))
        ok = alive[best]
        picked = picked.at[i].set(jnp.where(ok, best, -1))
        alive = alive & (iou[best] <= iou_th)
        alive = alive.at[best].set(False)
        return alive, picked

    alive0 = scores > -jnp.inf
    _, picked = jax.lax.fori_loop(
        0, n_out, body, (alive0, -jnp.ones(n_out, jnp.int32)))
    return picked


def roi_align(feats: list, boxes: jnp.ndarray, out_size: int,
              image_hw: tuple) -> jnp.ndarray:
    """Crop [R, out, out, C] from the FPN level chosen per-box (the
    sqrt(wh)/224 rule of model.py PyramidROIAlign), via bilinear sampling.

    Layout: all four levels are flattened into ONE [sum(h*w), C] buffer
    and each output pixel's 4 bilinear corners become global flat indices
    through the box's level offset — 4 gathers of [R, out, out, C] total.
    (The first formulation cropped every box from every level then selected:
    its per-tap advanced indexing gathered full-width feature rows, ~150M
    elements per forward at 480x640.)"""
    strides = (4, 8, 16, 32)
    lvls = feats[:4]
    shapes = [(f.shape[1], f.shape[2]) for f in lvls]
    C = lvls[0].shape[-1]
    flat = jnp.concatenate([f[0].reshape(-1, C) for f in lvls], axis=0)
    offsets = np.cumsum([0] + [h * w for h, w in shapes])[:4]

    h = jnp.maximum(boxes[:, 2] - boxes[:, 0], 1.0)
    w = jnp.maximum(boxes[:, 3] - boxes[:, 1], 1.0)
    level = jnp.clip(jnp.floor(2 + jnp.log2(jnp.sqrt(h * w) / 224.0 + 1e-9)),
                     0, 3).astype(jnp.int32)   # P2..P5
    stride = jnp.asarray(strides, jnp.float32)[level][:, None]      # [R,1]
    fh = jnp.asarray([s[0] for s in shapes], jnp.int32)[level][:, None]
    fw = jnp.asarray([s[1] for s in shapes], jnp.int32)[level][:, None]
    off = jnp.asarray(offsets, jnp.int32)[level][:, None, None]     # [R,1,1]

    ys = jnp.linspace(0.0, 1.0, out_size)
    xs = jnp.linspace(0.0, 1.0, out_size)
    y = (boxes[:, 0:1] + ys[None] * (boxes[:, 2:3] - boxes[:, 0:1])) \
        / stride - 0.5                                              # [R,out]
    x = (boxes[:, 1:2] + xs[None] * (boxes[:, 3:4] - boxes[:, 1:2])) \
        / stride - 0.5
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    fy = (y - y0)[:, :, None, None]
    fx = (x - x0)[:, None, :, None]
    fwr = fw[:, :, None]                                            # [R,1,1]

    def tap(yi, xi):
        yi = jnp.clip(yi, 0, fh - 1)[:, :, None]                    # [R,out,1]
        xi = jnp.clip(xi, 0, fw - 1)[:, None, :]                    # [R,1,out]
        return flat[off + yi * fwr + xi]                            # [R,o,o,C]

    return (tap(y0, x0) * (1 - fy) * (1 - fx)
            + tap(y0, x0 + 1) * (1 - fy) * fx
            + tap(y0 + 1, x0) * fy * (1 - fx)
            + tap(y0 + 1, x0 + 1) * fy * fx)


# ----------------------------------------------------------------------------
# Full model
# ----------------------------------------------------------------------------

class MaskRCNN(nn.Module):
    image_hw: tuple = (480, 640)
    pre_nms: int = 1024
    post_nms: int = 128
    max_det: int = 32
    blocks: Sequence[int] = (3, 4, 6, 3)   # ResNet50; smaller for tests

    def setup(self):
        self.backbone = ResNetFPN(blocks=self.blocks)
        self.rpn = RPNHead()
        self.box_head = BoxHead()
        self.mask_head = MaskHead()

    def backbone_stats(self, image: jnp.ndarray):
        """One backbone pass in batch-stats mode — apply with
        mutable=["batch_stats"] to calibrate the frozen-BN running stats
        (see calibrate_batch_stats)."""
        x = image[None] - jnp.asarray([123.7, 116.8, 103.9])
        return self.backbone(x, train=True)

    def __call__(self, image: jnp.ndarray, score_th: float = 0.7):
        """image [H, W, 3] float (0..255). Returns dict with fixed-size
        detections: boxes [D,4], classes [D], scores [D], masks [D,28,28]."""
        H, W = self.image_hw
        # matterport MEAN_PIXEL subtraction only (config.py) — no std
        # scaling, so converted weights see the distribution they trained on
        x = image[None] - jnp.asarray([123.7, 116.8, 103.9])
        feats = self.backbone(x)
        anchors = jnp.asarray(generate_anchors((H, W)))

        logits, deltas = [], []
        for f in feats:
            lg, dl = self.rpn(f)
            logits.append(lg[0])
            deltas.append(dl[0])
        logits = jnp.concatenate(logits)
        deltas = jnp.concatenate(deltas, axis=0)

        # Proposals: top pre_nms by objectness -> decode -> NMS -> post_nms.
        top_s, top_i = jax.lax.top_k(logits, self.pre_nms)
        props = apply_deltas(anchors[top_i], deltas[top_i] *
                             jnp.asarray([0.1, 0.1, 0.2, 0.2]))
        props = jnp.stack([jnp.clip(props[:, 0], 0, H), jnp.clip(props[:, 1], 0, W),
                           jnp.clip(props[:, 2], 0, H), jnp.clip(props[:, 3], 0, W)], -1)
        keep = nms_fixed(props, top_s, 0.7, self.post_nms)
        rois = props[jnp.maximum(keep, 0)]
        roi_valid = keep >= 0

        # Box head.
        crops = roi_align(feats, rois, 7, (H, W))
        cls_logits, box_deltas = self.box_head(crops)
        probs = jax.nn.softmax(cls_logits, axis=-1)
        cls = jnp.argmax(probs[:, 1:], axis=-1) + 1
        score = jnp.max(probs[:, 1:], axis=-1) * roi_valid
        d = jnp.take_along_axis(box_deltas, cls[:, None, None].repeat(4, -1),
                                axis=1)[:, 0]
        boxes = apply_deltas(rois, d * jnp.asarray([0.1, 0.1, 0.2, 0.2]))
        boxes = jnp.stack([jnp.clip(boxes[:, 0], 0, H), jnp.clip(boxes[:, 1], 0, W),
                           jnp.clip(boxes[:, 2], 0, H), jnp.clip(boxes[:, 3], 0, W)], -1)
        score = jnp.where(score >= score_th, score, 0.0)
        det_keep = nms_fixed(boxes, jnp.where(score > 0, score, -jnp.inf),
                             0.3, self.max_det)
        det_rows = jnp.maximum(det_keep, 0)
        det_valid = (det_keep >= 0) & (score[det_rows] > 0)
        det_boxes = boxes[det_rows]
        det_cls = cls[det_rows]
        det_scores = score[det_rows] * det_valid

        # Mask head on final detections.
        mask_crops = roi_align(feats, det_boxes, 14, (H, W))
        masks = jax.nn.sigmoid(self.mask_head(mask_crops))
        det_masks = jax.vmap(lambda m, c: m[:, :, c])(masks, det_cls)
        return {"boxes": det_boxes, "classes": det_cls, "scores": det_scores,
                "masks": det_masks, "valid": det_valid}

    def train_losses(self, image: jnp.ndarray, gt_boxes: jnp.ndarray,
                     gt_classes: jnp.ndarray, gt_mask: jnp.ndarray,
                     gt_valid: jnp.ndarray):
        """Training losses (model.py's rpn_*_loss + mrcnn_*_loss graphs):
        RPN objectness/box towards IoU-matched anchors; class/box/mask heads
        teacher-forced on the ground-truth boxes as ROIs.

        gt_boxes [G, 4] (y1,x1,y2,x2), gt_classes [G], gt_mask [H, W]
        (instance-presence map), gt_valid [G]."""
        H, W = self.image_hw
        x = image[None] - jnp.asarray([123.7, 116.8, 103.9])
        feats = self.backbone(x)
        anchors = jnp.asarray(generate_anchors((H, W)))
        logits, deltas = [], []
        for f in feats:
            lg, dl = self.rpn(f)
            logits.append(lg[0])
            deltas.append(dl[0])
        logits = jnp.concatenate(logits)
        deltas = jnp.concatenate(deltas, axis=0)

        iou = box_iou(anchors, gt_boxes) * gt_valid[None, :]
        best_iou = jnp.max(iou, axis=1)
        best_gt = jnp.argmax(iou, axis=1)
        pos = best_iou > 0.5
        # every gt's single best anchor is positive even below the threshold
        top_anchor = jnp.argmax(iou, axis=0)
        pos = pos.at[top_anchor].set(pos[top_anchor] | gt_valid)
        neg = best_iou < 0.3
        cls_tgt = pos.astype(jnp.float32)
        bce = optax_sigmoid_bce(logits, cls_tgt)
        n_pos = jnp.maximum(jnp.sum(pos), 1)
        n_neg = jnp.maximum(jnp.sum(neg), 1)
        rpn_cls = jnp.sum(jnp.where(pos, bce, 0)) / n_pos + \
            jnp.sum(jnp.where(neg, bce, 0)) / n_neg

        tgt = box_deltas_inverse(anchors, gt_boxes[best_gt]) / \
            jnp.asarray([0.1, 0.1, 0.2, 0.2])
        rpn_box = jnp.sum(jnp.where(pos[:, None],
                                    huber(deltas - tgt), 0)) / n_pos

        # Heads on gt boxes as ROIs, PLUS negative (background) ROIs — the
        # class head must learn class-0 for off-object regions or every
        # proposal scores as foreground at inference (model.py's
        # detection_targets_graph samples negatives at 2:1 for the same
        # reason). Negatives: the full image, shifted gt boxes, and fixed
        # image quadrants.
        G = gt_boxes.shape[0]
        shift = jnp.stack([gt_boxes[:, 2] - gt_boxes[:, 0],
                           jnp.zeros(G), gt_boxes[:, 2] - gt_boxes[:, 0],
                           jnp.zeros(G)], -1) * 1.5
        neg_boxes = jnp.concatenate([
            jnp.asarray([[0.0, 0.0, H, W],
                         [0.0, 0.0, H / 2, W / 2],
                         [H / 2, W / 2, H, W]]),
            jnp.clip(gt_boxes + shift, 0.0,
                     jnp.asarray([H, W, H, W], jnp.float32)),
        ], axis=0)
        # a shifted box overlapping a gt object is not a clean negative
        neg_iou = jnp.max(box_iou(neg_boxes, gt_boxes) * gt_valid[None, :],
                          axis=1)
        neg_valid = neg_iou < 0.3
        roi_boxes = jnp.concatenate([gt_boxes, neg_boxes], axis=0)
        roi_classes = jnp.concatenate(
            [gt_classes, jnp.zeros(neg_boxes.shape[0], gt_classes.dtype)])
        roi_valid = jnp.concatenate([gt_valid, neg_valid])
        crops = roi_align(feats, roi_boxes, 7, (H, W))
        cls_logits, box_d_all = self.box_head(crops)
        ce = -jax.nn.log_softmax(cls_logits)[
            jnp.arange(roi_boxes.shape[0]), roi_classes]
        head_cls = jnp.sum(jnp.where(roi_valid, ce, 0)) / \
            jnp.maximum(jnp.sum(roi_valid), 1)
        box_d = box_d_all[:G]
        # Box refinement: with ROIs == gt boxes the target deltas are zero.
        d_sel = box_d[jnp.arange(gt_boxes.shape[0]), gt_classes]
        head_box = jnp.sum(jnp.where(gt_valid[:, None], huber(d_sel), 0)) / \
            jnp.maximum(jnp.sum(gt_valid) * 4, 1)
        mask_crops = roi_align(feats, gt_boxes, 14, (H, W))
        mask_logits = self.mask_head(mask_crops)   # [G, 28, 28, C]
        m_sel = jax.vmap(lambda m, c: m[:, :, c])(mask_logits, gt_classes)
        gt28 = jax.vmap(lambda b: crop_mask(gt_mask, b, 28))(gt_boxes)
        mbce = optax_sigmoid_bce(m_sel, gt28)
        head_mask = jnp.sum(jnp.where(gt_valid[:, None, None], mbce, 0)) / \
            jnp.maximum(jnp.sum(gt_valid) * 28 * 28, 1)
        return rpn_cls + rpn_box + head_cls + head_box + head_mask

    def train_losses_sampled(self, image: jnp.ndarray, gt_boxes: jnp.ndarray,
                             gt_classes: jnp.ndarray, gt_mask: jnp.ndarray,
                             gt_valid: jnp.ndarray, n_rois: int = 64,
                             pos_ratio: float = 0.33):
        """The reference's full training graph: RPN losses on IoU-matched
        anchors PLUS heads trained on RPN *proposals* sampled at a fixed
        positive ratio (ProposalLayer model.py:224-280 +
        detection_targets_graph model.py:451-560, TRAIN_ROIS_PER_IMAGE /
        ROI_POSITIVE_RATIO=0.33 config semantics).

        Unlike `train_losses` (teacher-forced on gt boxes — cheap, used by
        the toy fit), this trains the box head on *imperfect* proposals so
        its refinement deltas are non-trivial, exactly like the reference.
        Returns a dict of named losses incl. "total"."""
        H, W = self.image_hw
        x = image[None] - jnp.asarray([123.7, 116.8, 103.9])
        feats = self.backbone(x)
        anchors = jnp.asarray(generate_anchors((H, W)))
        logits, deltas = [], []
        for f in feats:
            lg, dl = self.rpn(f)
            logits.append(lg[0])
            deltas.append(dl[0])
        logits = jnp.concatenate(logits)
        deltas = jnp.concatenate(deltas, axis=0)

        # --- RPN losses (rpn_class_loss_graph/rpn_bbox_loss_graph,
        # model.py:943-1005) — identical targets to train_losses.
        iou = box_iou(anchors, gt_boxes) * gt_valid[None, :]
        best_iou = jnp.max(iou, axis=1)
        best_gt = jnp.argmax(iou, axis=1)
        pos = best_iou > 0.5
        top_anchor = jnp.argmax(iou, axis=0)
        pos = pos.at[top_anchor].set(pos[top_anchor] | gt_valid)
        neg = best_iou < 0.3
        bce = optax_sigmoid_bce(logits, pos.astype(jnp.float32))
        n_pos = jnp.maximum(jnp.sum(pos), 1)
        rpn_cls = jnp.sum(jnp.where(pos, bce, 0)) / n_pos + \
            jnp.sum(jnp.where(neg, bce, 0)) / jnp.maximum(jnp.sum(neg), 1)
        tgt = box_deltas_inverse(anchors, gt_boxes[best_gt]) / BBOX_STD
        rpn_box = jnp.sum(jnp.where(pos[:, None],
                                    huber(deltas - tgt), 0)) / n_pos

        # --- ProposalLayer (model.py:224-280): decode top anchors, clip,
        # NMS. stop_gradient: proposal COORDINATES are training data for the
        # heads, not a differentiable path (the reference's graph likewise
        # samples targets outside the gradient tape).
        p_logits = jax.lax.stop_gradient(logits)
        p_deltas = jax.lax.stop_gradient(deltas)
        top_s, top_i = jax.lax.top_k(p_logits, self.pre_nms)
        props = apply_deltas(anchors[top_i], p_deltas[top_i] * BBOX_STD)
        props = jnp.stack([jnp.clip(props[:, 0], 0, H),
                           jnp.clip(props[:, 1], 0, W),
                           jnp.clip(props[:, 2], 0, H),
                           jnp.clip(props[:, 3], 0, W)], -1)
        keep = nms_fixed(props, top_s, 0.7, self.post_nms)
        proposals = props[jnp.maximum(keep, 0)]
        prop_valid = keep >= 0

        rois, roi_cls, box_tgt, is_pos, roi_valid, _ = detection_targets(
            proposals, prop_valid, gt_boxes, gt_classes, gt_valid,
            n_rois=n_rois, pos_ratio=pos_ratio)

        # --- heads on the sampled ROIs (mrcnn_*_loss_graph,
        # model.py:1007-1080).
        crops = roi_align(feats, rois, 7, (H, W))
        cls_logits, box_d_all = self.box_head(crops)
        R = rois.shape[0]
        ce = -jax.nn.log_softmax(cls_logits)[jnp.arange(R), roi_cls]
        head_cls = jnp.sum(jnp.where(roi_valid, ce, 0)) / \
            jnp.maximum(jnp.sum(roi_valid), 1)
        d_sel = box_d_all[jnp.arange(R), roi_cls]
        head_box = jnp.sum(jnp.where(is_pos[:, None],
                                     huber(d_sel - box_tgt), 0)) / \
            jnp.maximum(jnp.sum(is_pos) * 4, 1)
        mask_crops = roi_align(feats, rois, 14, (H, W))
        mask_logits = self.mask_head(mask_crops)
        m_sel = jax.vmap(lambda m, c: m[:, :, c])(mask_logits, roi_cls)
        roi28 = jax.vmap(lambda b: crop_mask(gt_mask, b, 28))(rois)
        mbce = optax_sigmoid_bce(m_sel, roi28)
        head_mask = jnp.sum(jnp.where(is_pos[:, None, None], mbce, 0)) / \
            jnp.maximum(jnp.sum(is_pos) * 28 * 28, 1)
        total = rpn_cls + rpn_box + head_cls + head_box + head_mask
        return {"total": total, "rpn_class": rpn_cls, "rpn_box": rpn_box,
                "head_class": head_cls, "head_box": head_box,
                "head_mask": head_mask,
                "n_pos_rois": jnp.sum(is_pos).astype(jnp.float32)}


def optax_sigmoid_bce(logits, labels):
    """Numerically-stable sigmoid BCE."""
    return jnp.maximum(logits, 0) - logits * labels + \
        jnp.log1p(jnp.exp(-jnp.abs(logits)))


def huber(x, delta: float = 1.0):
    a = jnp.abs(x)
    return jnp.where(a < delta, 0.5 * a * a, delta * (a - 0.5 * delta))


def box_deltas_inverse(boxes: jnp.ndarray, targets: jnp.ndarray) -> jnp.ndarray:
    """(dy, dx, log dh, log dw) that move `boxes` onto `targets`."""
    h = jnp.maximum(boxes[:, 2] - boxes[:, 0], 1e-3)
    w = jnp.maximum(boxes[:, 3] - boxes[:, 1], 1e-3)
    th = jnp.maximum(targets[:, 2] - targets[:, 0], 1e-3)
    tw = jnp.maximum(targets[:, 3] - targets[:, 1], 1e-3)
    cy = boxes[:, 0] + 0.5 * h
    cx = boxes[:, 1] + 0.5 * w
    tcy = targets[:, 0] + 0.5 * th
    tcx = targets[:, 1] + 0.5 * tw
    return jnp.stack([(tcy - cy) / h, (tcx - cx) / w,
                      jnp.log(th / h), jnp.log(tw / w)], -1)


def detection_targets(proposals: jnp.ndarray, prop_valid: jnp.ndarray,
                      gt_boxes: jnp.ndarray, gt_classes: jnp.ndarray,
                      gt_valid: jnp.ndarray, n_rois: int = 64,
                      pos_ratio: float = 0.33):
    """Static-shape redesign of detection_targets_graph (model.py:451-560).

    The reference RANDOMLY subsamples positives to TRAIN_ROIS_PER_IMAGE *
    ROI_POSITIVE_RATIO and fills the rest with negatives (model.py:503-513).
    Random gathers with data-dependent counts don't fit one XLA program, so
    selection is deterministic top-k instead: positives by match IoU;
    negatives in two strata — half HARD (highest IoU below the 0.5 bar:
    the near-miss proposals that carry the strongest gradient) and half
    EASY (lowest IoU: true background), approximating the class balance the
    reference's random sampling finds in expectation. Pure-hard selection
    starved the class head of real background whenever near-misses
    clustered around objects.

    Returns (rois [n,4], roi_cls [n], box_tgt [n,4] BBOX_STD-normalized,
    is_pos [n] bool, roi_valid [n] bool, matched_gt [n] int)."""
    iou = box_iou(proposals, gt_boxes) * gt_valid[None, :]
    iou = jnp.where(prop_valid[:, None], iou, 0.0)
    best_iou = jnp.max(iou, axis=1)
    best_gt = jnp.argmax(iou, axis=1)
    pos = (best_iou >= 0.5) & prop_valid          # model.py:494
    neg = (best_iou < 0.5) & prop_valid           # model.py:498
    P = proposals.shape[0]
    n_pos = min(max(1, int(round(n_rois * pos_ratio))), P)
    n_neg = min(n_rois - n_pos, P)
    pv, pi = jax.lax.top_k(jnp.where(pos, best_iou, -1.0), n_pos)
    pos_ok = pv >= 0.5
    n_hard = n_neg // 2
    n_easy = n_neg - n_hard
    hv, hi = jax.lax.top_k(jnp.where(neg, best_iou, -1.0), n_hard)
    hard_ok = hv >= 0.0
    taken = jnp.zeros(P, bool).at[hi].set(hard_ok)
    easy_pool = neg & ~taken
    ev, ei = jax.lax.top_k(jnp.where(easy_pool, -best_iou, -2.0), n_easy)
    easy_ok = ev >= -1.0
    ni = jnp.concatenate([hi, ei])
    neg_ok = jnp.concatenate([hard_ok, easy_ok])
    idx = jnp.concatenate([pi, ni])
    roi_valid = jnp.concatenate([pos_ok, neg_ok])
    is_pos = jnp.concatenate([pos_ok, jnp.zeros(n_neg, bool)])
    rois = proposals[idx]
    matched_gt = best_gt[idx]
    roi_cls = jnp.where(is_pos, gt_classes[matched_gt], 0)
    box_tgt = box_deltas_inverse(rois, gt_boxes[matched_gt]) / \
        jnp.asarray(BBOX_STD)
    box_tgt = jnp.where(is_pos[:, None], box_tgt, 0.0)
    return rois, roi_cls, box_tgt, is_pos, roi_valid, matched_gt


def crop_mask(mask: jnp.ndarray, box: jnp.ndarray, out: int) -> jnp.ndarray:
    """Bilinear crop of a full-image mask to the box, resampled to out^2
    (the minimask construction of utils.py)."""
    H, W = mask.shape
    ys = box[0] + (jnp.arange(out) + 0.5) / out * (box[2] - box[0]) - 0.5
    xs = box[1] + (jnp.arange(out) + 0.5) / out * (box[3] - box[1]) - 0.5
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, H - 2)
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, W - 2)
    fy = jnp.clip(ys - y0, 0, 1)[:, None]
    fx = jnp.clip(xs - x0, 0, 1)[None, :]
    m = mask.astype(jnp.float32)
    return (m[y0][:, x0] * (1 - fy) * (1 - fx) + m[y0][:, x0 + 1] * (1 - fy) * fx
            + m[y0 + 1][:, x0] * fy * (1 - fx) + m[y0 + 1][:, x0 + 1] * fy * fx)


def calibrate_batch_stats(model: "MaskRCNN", variables, images,
                          passes: int = 2):
    """Set the frozen-BN running stats from real activation statistics.

    The reference trains with TRAIN_BN=False on top of pretrained weights
    whose BN moving stats already match the data (model.py:1929 config
    comment); `convert_keras_h5` carries those over. From-scratch training
    has no such stats — the init (mean 0, var 1) leaves raw-image-scale
    activations unnormalized through the whole ResNet, blowing RPN/head
    logits to ~1e2 and making the loss landscape untrainable (measured:
    total loss 576 at init, rising under Adam). Each calibration pass runs
    the backbone in batch-stats mode (momentum 0 = direct assignment), so
    layer k+1's stats are computed under layer k's batch normalization —
    after a couple of passes the frozen forward reproduces the calibrated
    one. Returns variables with updated batch_stats."""
    fwd = jax.jit(lambda v, im: model.apply(
        v, im, method=MaskRCNN.backbone_stats, mutable=["batch_stats"]))
    for _ in range(passes):
        stats = []
        for i in range(images.shape[0]):
            _, upd = fwd(variables, images[i])
            stats.append(upd["batch_stats"])
        avg = jax.tree.map(lambda *xs: jnp.mean(jnp.stack(xs), 0), *stats)
        variables = {**variables, "batch_stats": avg}
    return variables


def train_toy(model: "MaskRCNN", variables, images, boxes, classes, masks,
              valids, steps: int = 100, lr: float = 1e-3, seed: int = 0,
              calibrate: bool = True):
    """Few-epoch fit on synthetic data so the semantic stack can produce
    non-random masks in tests (no pretrained weights are downloadable in
    this environment). images [B,H,W,3]; boxes [B,G,4]; classes [B,G];
    masks [B,H,W]; valids [B,G]. Returns trained variables.

    calibrate=False preserves the incoming batch_stats — REQUIRED when
    fine-tuning weights converted from the pretrained h5, whose BN moving
    stats the reference's TRAIN_BN=False workflow depends on (model.py:1929);
    calibration would overwrite them with this tiny batch's statistics."""
    import optax
    # clip like the reference (config.py GRADIENT_CLIP_NORM = 5.0)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(lr))
    if calibrate:
        variables = calibrate_batch_stats(model, variables, images)

    def loss_fn(params, batch_stats, img, bx, cl, mk, vd):
        return model.apply({"params": params, "batch_stats": batch_stats},
                           img, bx, cl, mk, vd, method=MaskRCNN.train_losses)

    params = variables["params"]
    batch_stats = variables["batch_stats"]
    opt_state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    B = images.shape[0]
    for step in range(steps):
        i = step % B
        loss, grads = grad_fn(params, batch_stats, images[i], boxes[i],
                              classes[i], masks[i], valids[i])
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
    return {"params": params, "batch_stats": batch_stats}


def train_sampled(model: "MaskRCNN", variables, images, boxes, classes,
                  masks, valids, steps: int = 100, lr: float = 1e-3,
                  batch: int = 2, seed: int = 0,
                  with_components: bool = False, calibrate: bool = True):
    """Batched proposal-sampled training — the shape of the reference's real
    training loop (model.py:2130-2230 MaskRCNN.train consumes batched
    detection targets from detection_targets_graph). vmaps
    `train_losses_sampled` over a B-image mini-batch and steps the
    reference's optimizer — SGD momentum 0.9 with global-norm clip 5.0
    (model.py:2165-2171, config.py LEARNING_RATE/LEARNING_MOMENTUM/
    GRADIENT_CLIP_NORM) — on the mean total loss. SGD is ALSO the
    numerically-correct choice here: Adam takes a full lr-sized step on
    EVERY parameter from step 0 (measured: the frozen-BN backbone's
    activations compounded multiplicatively, rpn_box loss 5.5 -> 772 in two
    steps at lr=1e-3), while clipped SGD bounds the global step norm at
    clip*lr. Returns (variables, per-step losses); with with_components=True
    also returns the per-step named-loss dicts.

    calibrate=False preserves incoming (e.g. pretrained-h5) batch_stats —
    see train_toy."""
    import optax
    # the reference's optimizer: SGD(lr, momentum=0.9) + clipnorm 5.0
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.sgd(lr, momentum=0.9))
    if calibrate:
        variables = calibrate_batch_stats(model, variables, images)

    def one_loss(params, batch_stats, img, bx, cl, mk, vd):
        return model.apply({"params": params, "batch_stats": batch_stats},
                           img, bx, cl, mk, vd,
                           method=MaskRCNN.train_losses_sampled)

    def loss_fn(params, batch_stats, imgs, bxs, cls_, mks, vds):
        f = jax.vmap(one_loss, in_axes=(None, None, 0, 0, 0, 0, 0))
        comps = jax.tree.map(
            lambda x: jnp.mean(x),
            f(params, batch_stats, imgs, bxs, cls_, mks, vds))
        return comps["total"], comps

    params = variables["params"]
    batch_stats = variables["batch_stats"]
    opt_state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    B = images.shape[0]
    losses = []
    components = []
    order = np.random.default_rng(seed).permutation(B)
    for step in range(steps):
        sel = order[np.arange(step * batch, (step + 1) * batch) % B]
        (loss, comps), grads = grad_fn(params, batch_stats, images[sel],
                                       boxes[sel], classes[sel], masks[sel],
                                       valids[sel])
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
        components.append({k: float(v) for k, v in comps.items()})
    out_vars = {"params": params, "batch_stats": batch_stats}
    if with_components:
        return out_vars, losses, components
    return out_vars, losses


def paste_masks(det: dict, image_hw: tuple, dynamic_only: bool = True,
                mask_th: float = 0.5) -> jnp.ndarray:
    """GetDynSeg (MaskRCNN.py:83-140): paste instance masks into a full-
    resolution binary map (1 = dynamic object present)."""
    H, W = image_hw
    out = jnp.zeros((H, W))
    ys = jnp.arange(H, dtype=jnp.float32)
    xs = jnp.arange(W, dtype=jnp.float32)
    ks = jnp.arange(28, dtype=jnp.float32)

    def interp_matrix(coord, lo, hi):
        """[P, 28] separable bilinear weights mapping mask axis -> pixels.

        Bilinear resampling factorizes per axis, so the paste becomes
        Ky @ m @ Kx^T — two small matmuls, mathematically identical to the
        per-pixel 2-D gather formulation (m[y0, x0] over the full [H, W]
        grid x 4 taps x every detection) with far fewer memory reads."""
        f = (coord - lo) / jnp.maximum(hi - lo, 1.0) * 28 - 0.5
        k0 = jnp.clip(jnp.floor(f), 0, 26)
        w = jnp.clip(f - k0, 0, 1)
        K = jnp.where(ks[None, :] == k0[:, None], (1 - w)[:, None], 0.0) + \
            jnp.where(ks[None, :] == k0[:, None] + 1, w[:, None], 0.0)
        return K

    def one(i, out):
        box = det["boxes"][i]
        m = det["masks"][i]
        is_dyn = jnp.any(det["classes"][i] == jnp.asarray(DYNAMIC_CLASS_IDS)) \
            if dynamic_only else True
        ok = det["valid"][i] & is_dyn
        Ky = interp_matrix(ys, box[0], box[2])              # [H, 28]
        Kx = interp_matrix(xs, box[1], box[3])              # [W, 28]
        v = (Ky @ m) @ Kx.T                                 # [H, W]
        inside = (ys[:, None] >= box[0]) & (ys[:, None] < box[2]) & \
                 (xs[None, :] >= box[1]) & (xs[None, :] < box[3])
        return jnp.where(ok & inside & (v > mask_th), 1.0, out)

    return jax.lax.fori_loop(0, det["boxes"].shape[0], one, out)


class FlaxSegmenter:
    """Callable segmenter for masking.masknet.SegmentDynObject.

    infer_hw: internal inference resolution. The reference likewise resizes
    internally (mold_inputs, model.py — every input is remolded to the
    config's IMAGE_MIN/MAX_DIM before the backbone); here the default molds
    LARGE inputs (>=384 rows) to half resolution, which quarters the
    backbone/RPN cost. Detection boxes are rescaled to the output frame and
    the 28x28 instance masks are pasted at FULL output resolution, so mask
    sharpness is set by the instance-mask head, not the backbone grid.
    Pass infer_hw=image_hw to force native-resolution inference."""

    def __init__(self, params=None, image_hw=(480, 640), seed: int = 0,
                 infer_hw: tuple | None = None,
                 blocks: tuple = (3, 4, 6, 3)):
        if infer_hw is None:
            infer_hw = (image_hw[0] // 2, image_hw[1] // 2) \
                if image_hw[0] >= 384 else image_hw
        self.model = MaskRCNN(image_hw=infer_hw, blocks=tuple(blocks))
        self.image_hw = image_hw
        self.infer_hw = infer_hw
        if params is None:
            dummy = jnp.zeros(infer_hw + (3,))
            params = self.model.init(jax.random.PRNGKey(seed), dummy)
        self.params = params
        sy = image_hw[0] / infer_hw[0]
        sx = image_hw[1] / infer_hw[1]
        # Params travel as ONE flat f32 buffer, unflattened inside the jit
        # with static offsets: one argument per dispatch instead of the
        # model's 307 param leaves, whose per-argument cost ROADMAP A5
        # re-measures. (Baking the weights in as closure constants would
        # make every compile carry ~100 MB of literals.)
        leaves, self._treedef = jax.tree_util.tree_flatten(self.params)
        self._shapes = [l.shape for l in leaves]
        sizes = [int(np.prod(s)) for s in self._shapes]
        self._offsets = np.cumsum([0] + sizes)
        self._flat = jnp.concatenate(
            [jnp.asarray(l, jnp.float32).reshape(-1) for l in leaves])

        def apply(flat, im):
            lv = [jax.lax.dynamic_slice(flat, (int(o),), (int(n),))
                  .reshape(s) for o, n, s in
                  zip(self._offsets[:-1], sizes, self._shapes)]
            p = jax.tree_util.tree_unflatten(self._treedef, lv)
            im = im.astype(jnp.float32)   # uint8 input: 4x less upload
            if infer_hw != image_hw:
                im = jax.image.resize(im, infer_hw + (3,), "bilinear")
            det = self.model.apply(p, im)
            det = {**det, "boxes": det["boxes"] *
                   jnp.asarray([sy, sx, sy, sx])}
            # uint8 output: a quarter of the float32 [H, W] mask's bytes
            # to download per frame (1.2 -> 0.3 MB)
            return paste_masks(det, image_hw).astype(jnp.uint8)

        self._apply = jax.jit(apply)

    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        return np.asarray(self._apply(self._flat, jnp.asarray(rgb)),
                          np.float32)


def save_variables(variables, path: str, meta: dict | None = None):
    """Serialize a flax variables dict ({'params': ..., 'batch_stats': ...})
    to one .npz (flattened by path). `meta` (e.g. {'blocks': [1,1,1,1],
    'infer_hw': [120,160]}) records the model shape so build_segmenter can
    reconstruct the matching architecture."""
    import json
    flat = {}
    for col, tree in variables.items():
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        for kp, leaf in leaves:
            key = col + "/" + "/".join(
                getattr(k, "key", getattr(k, "idx", "?")).__str__()
                for k in kp)
            flat[key] = np.asarray(leaf)
    if meta:
        flat["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **flat)


def load_variables(path: str):
    """Inverse of save_variables: rebuild the nested variables dict."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if key == "__meta__":
                continue
            parts = key.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(z[key])
    return out


def load_meta(path: str) -> dict:
    """The meta dict stored by save_variables ({} if absent)."""
    import json
    with np.load(path) as z:
        if "__meta__" not in z.files:
            return {}
        return json.loads(bytes(z["__meta__"]).decode())


def build_segmenter(spec: str, image_hw=(480, 640)):
    """Construct a live segmenter from a CLI spec (the `--segmenter` option
    of cli/rgbd_tum and cli/evaluate — the reference's always-on MaskNet,
    MaskNet.cc:30-49, made opt-in since no pretrained weights ship in
    either repo):

      'flax'            random weights (architecture smoke only — warns)
      'flax:W.npz'      trained variables from save_variables
      'flax:W.h5'       the reference's Keras mask_rcnn_coco.h5, converted
    """
    if not spec.startswith("flax"):
        raise ValueError(f"unknown segmenter spec '{spec}'")
    weights = spec.split(":", 1)[1] if ":" in spec else None
    params = None
    infer_hw = None
    blocks = (3, 4, 6, 3)
    if weights:
        if weights.endswith(".h5"):
            ih = (image_hw[0] // 2, image_hw[1] // 2) \
                if image_hw[0] >= 384 else image_hw
            params = convert_keras_h5(weights, image_hw=ih)
            infer_hw = ih
        else:
            params = load_variables(weights)
            meta = load_meta(weights)
            if "blocks" in meta:
                blocks = tuple(meta["blocks"])
            if "infer_hw" in meta:
                infer_hw = tuple(meta["infer_hw"])
    else:
        import warnings
        warnings.warn("--segmenter flax without weights: the net is "
                      "randomly initialized and its masks are meaningless; "
                      "pass flax:weights.npz or flax:mask_rcnn_coco.h5")
    return FlaxSegmenter(params=params, image_hw=image_hw,
                         infer_hw=infer_hw, blocks=blocks)


# ----------------------------------------------------------------------------
# Keras h5 weight conversion (reference mask_rcnn_coco.h5, matterport layout)
# ----------------------------------------------------------------------------

# ResNet50 stage layout: (stage number, block letters) -> Bottleneck_i order.
_RESNET_STAGES = ((2, "abc"), (3, "abcd"), (4, "abcdef"), (5, "abc"))


def _h5_weight(f, layer: str, suffix: str):
    """Fetch a weight array from a Keras-format h5: the group `layer` holds
    datasets whose names end with `<suffix>:0` (possibly nested one level,
    e.g. f['conv1']['conv1']['kernel:0'] or f['rpn_model']['rpn_conv_shared/
    kernel:0'])."""
    import numpy as _np

    def search(group):
        hit = None
        for k in group:
            item = group[k]
            if hasattr(item, "shape"):
                if k.endswith(suffix + ":0") or k == suffix:
                    return _np.asarray(item)
            else:
                hit = hit if hit is not None else search(item)
                if hit is not None:
                    return hit
        return hit

    if layer not in f:
        raise KeyError(f"h5 layer '{layer}' not found")
    got = search(f[layer])
    if got is None:
        raise KeyError(f"weight '{suffix}:0' not found under layer '{layer}'")
    return got


def _fold_bn(f, bn_layer: str, conv_bias=None, eps: float = 1e-3):
    """Keras BN weights -> flax (scale, bias, mean, var); a preceding conv
    bias is folded into the running mean (our convs are bias-free)."""
    gamma = _h5_weight(f, bn_layer, "gamma")
    beta = _h5_weight(f, bn_layer, "beta")
    mean = _h5_weight(f, bn_layer, "moving_mean")
    var = _h5_weight(f, bn_layer, "moving_variance")
    if conv_bias is not None:
        mean = mean - conv_bias
    return gamma, beta, mean, var


def _fold_bn_into_dense(kernel, bias, f, bn_layer: str, eps: float = 1e-3):
    """Inference-mode BN folded into the preceding dense/conv weights:
    y = gamma*(Wx+b-mean)/sqrt(var+eps)+beta -> W' x + b'."""
    gamma, beta, mean, var = _fold_bn(f, bn_layer)
    s = gamma / np.sqrt(var + eps)
    return kernel * s, (bias - mean) * s + beta


def convert_keras_h5(h5_path: str, image_hw=(480, 640)):
    """Map the reference's `mask_rcnn_coco.h5` (matterport Keras layout —
    MaskRCNN.py:15-61 loads it with `load_weights(..., by_name=True)`) into
    this module's parameter tree. Returns the flax variables dict usable as
    `FlaxSegmenter(params=...)`.

    Layout contract (per-layer h5 groups with Keras `<name>:0` datasets):
    conv1/bn_conv1 stem; res{S}{b}_branch{1,2a,2b,2c} + bn counterparts;
    fpn_c{2..5}p{2..5} + fpn_p{2..5}; rpn_model (rpn_conv_shared,
    rpn_class_raw [2 logits/anchor -> folded to 1 as fg-bg], rpn_bbox_pred);
    mrcnn_class_conv1/2+bn (BN folded into the dense weights),
    mrcnn_class_logits, mrcnn_bbox_fc; mrcnn_mask_conv1..4+bn (folded),
    mrcnn_mask_deconv, mrcnn_mask. Keras ConvTranspose kernels are
    [kh,kw,out,in] -> transposed to flax [kh,kw,in,out].
    """
    import h5py  # gated import: only needed when a weight file exists

    model = MaskRCNN(image_hw=image_hw)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros(image_hw + (3,)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])

    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def set_conv_bn(scope_p, scope_s, conv_key, bn_key, conv_layer,
                        bn_layer):
            k = _h5_weight(root, conv_layer, "kernel")
            try:
                b = _h5_weight(root, conv_layer, "bias")
            except KeyError:
                b = None
            scope_p[conv_key]["kernel"] = k.astype(np.float32)
            g, beta, mean, var = _fold_bn(root, bn_layer, conv_bias=b)
            scope_p[bn_key]["scale"] = g.astype(np.float32)
            scope_p[bn_key]["bias"] = beta.astype(np.float32)
            scope_s[bn_key]["mean"] = mean.astype(np.float32)
            scope_s[bn_key]["var"] = var.astype(np.float32)

        bb_p, bb_s = params["backbone"], stats["backbone"]
        set_conv_bn(bb_p, bb_s, "Conv_0", "BatchNorm_0", "conv1", "bn_conv1")
        blk = 0
        for stage, letters in _RESNET_STAGES:
            for j, letter in enumerate(letters):
                name = f"{stage}{letter}"
                bp = bb_p[f"Bottleneck_{blk}"]
                bs = bb_s[f"Bottleneck_{blk}"]
                for ci, branch in enumerate(("2a", "2b", "2c")):
                    set_conv_bn(bp, bs, f"Conv_{ci}", f"BatchNorm_{ci}",
                                f"res{name}_branch{branch}",
                                f"bn{name}_branch{branch}")
                if j == 0:  # projection shortcut
                    set_conv_bn(bp, bs, "Conv_3", "BatchNorm_3",
                                f"res{name}_branch1", f"bn{name}_branch1")
                blk += 1

        def set_conv(scope, key, layer, transpose_kernel=False):
            k = _h5_weight(root, layer, "kernel").astype(np.float32)
            if transpose_kernel:
                # Keras Conv2DTranspose kernels are (kh, kw, out, in) with
                # gradient-of-conv (scatter) semantics; flax ConvTranspose
                # lowers to lax.conv_transpose(transpose_kernel=False),
                # a fractionally-strided FORWARD conv — equivalence needs
                # the spatial FLIP on top of the (out, in) -> (in, out)
                # axis swap (verified against a scatter-form reference in
                # tests/test_maskrcnn.py).
                k = np.transpose(k[::-1, ::-1], (0, 1, 3, 2))
            scope[key]["kernel"] = k
            scope[key]["bias"] = _h5_weight(root, layer, "bias").astype(
                np.float32)

        # FPN lateral 1x1 then output 3x3 convs, in this module's call order.
        for key, layer in (("Conv_1", "fpn_c5p5"), ("Conv_2", "fpn_c4p4"),
                           ("Conv_3", "fpn_c3p3"), ("Conv_4", "fpn_c2p2"),
                           ("Conv_5", "fpn_p2"), ("Conv_6", "fpn_p3"),
                           ("Conv_7", "fpn_p4"), ("Conv_8", "fpn_p5")):
            set_conv(bb_p, key, layer)

        # RPN: shared conv; class logits folded 2->1 (fg - bg per anchor).
        rpn_p = params["rpn"]
        set_conv(rpn_p, "Conv_0", "rpn_conv_shared")
        kc = _h5_weight(root, "rpn_class_raw", "kernel").astype(np.float32)
        bc = _h5_weight(root, "rpn_class_raw", "bias").astype(np.float32)
        rpn_p["Conv_1"]["kernel"] = kc[..., 1::2] - kc[..., 0::2]
        rpn_p["Conv_1"]["bias"] = bc[1::2] - bc[0::2]
        set_conv(rpn_p, "Conv_2", "rpn_bbox_pred")

        # Box head: matterport's 7x7-valid + 1x1 convs == dense layers over
        # the flattened ROI; their BN layers are folded in (inference mode).
        bh = params["box_head"]
        k1 = _h5_weight(root, "mrcnn_class_conv1", "kernel").astype(np.float32)
        b1 = _h5_weight(root, "mrcnn_class_conv1", "bias").astype(np.float32)
        k1 = k1.reshape(-1, k1.shape[-1])
        k1, b1 = _fold_bn_into_dense(k1, b1, root, "mrcnn_class_bn1")
        bh["Dense_0"]["kernel"], bh["Dense_0"]["bias"] = k1, b1
        k2 = _h5_weight(root, "mrcnn_class_conv2", "kernel").astype(np.float32)
        b2 = _h5_weight(root, "mrcnn_class_conv2", "bias").astype(np.float32)
        k2 = k2.reshape(-1, k2.shape[-1])
        k2, b2 = _fold_bn_into_dense(k2, b2, root, "mrcnn_class_bn2")
        bh["Dense_1"]["kernel"], bh["Dense_1"]["bias"] = k2, b2
        bh["Dense_2"]["kernel"] = _h5_weight(
            root, "mrcnn_class_logits", "kernel").astype(np.float32)
        bh["Dense_2"]["bias"] = _h5_weight(
            root, "mrcnn_class_logits", "bias").astype(np.float32)
        bh["Dense_3"]["kernel"] = _h5_weight(
            root, "mrcnn_bbox_fc", "kernel").astype(np.float32)
        bh["Dense_3"]["bias"] = _h5_weight(
            root, "mrcnn_bbox_fc", "bias").astype(np.float32)

        # Mask head: conv+BN folded; deconv kernel axes swapped for flax.
        mh = params["mask_head"]
        for i in range(4):
            k = _h5_weight(root, f"mrcnn_mask_conv{i+1}", "kernel").astype(
                np.float32)
            b = _h5_weight(root, f"mrcnn_mask_conv{i+1}", "bias").astype(
                np.float32)
            k, b = _fold_bn_into_dense(k, b, root, f"mrcnn_mask_bn{i+1}")
            mh[f"Conv_{i}"]["kernel"], mh[f"Conv_{i}"]["bias"] = k, b
        set_conv(mh, "ConvTranspose_0", "mrcnn_mask_deconv",
                 transpose_kernel=True)
        set_conv(mh, "Conv_4", "mrcnn_mask")

    to_jnp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    return {"params": to_jnp(params), "batch_stats": to_jnp(stats)}
