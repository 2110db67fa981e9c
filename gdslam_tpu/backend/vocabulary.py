"""Binary BoW vocabulary: hierarchical k-medians on ORB descriptors.

Replaces DBoW2's TemplatedVocabulary + FORB (reference
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:241,1338): a k-ary tree of
256-bit binary cluster centers; `transform` walks each descriptor down the
tree by Hamming argmin; images become L1-normalized bag-of-words vectors
scored with the DBoW2 L1 metric s = 1 - 0.5*|v - w|_1.

Differences by design:
- The vocabulary is TRAINED IN-FRAMEWORK (the reference expects an external
  ORBvoc.txt from ORB-SLAM2 that ships with neither repo) — k-medians with
  bitwise-majority centroid updates, on device.
- The tree walk is a vmapped gather + int8 Hamming argmin per level; BoW
  vectors are kept dense ([n_leaves] float32, n_leaves ~ 10k), so database
  scoring is one matmul instead of an inverted file.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gdslam_tpu.ops import hamming, orb as orb_ops


class Vocabulary(NamedTuple):
    centers: jnp.ndarray   # [n_nodes, 32] uint8, level-major complete k-ary tree
    k: int                 # branching factor
    levels: int            # depth

    @property
    def n_leaves(self) -> int:
        return self.k ** self.levels


def _node_offset(k: int, level: int) -> int:
    """Start index of `level` in the level-major array (root level 0 = k nodes)."""
    return sum(k ** (l + 1) for l in range(level))


_POPCNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                        axis=1).sum(1).astype(np.int32)


def _ham_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[m, 32] x [k, 32] uint8 -> [m, k] Hamming distances (numpy LUT)."""
    return _POPCNT[np.bitwise_xor(a[:, None, :], b[None, :, :])].sum(-1)


def train(descriptors: np.ndarray, k: int = 10, levels: int = 3,
          iters: int = 8, seed: int = 0,
          max_per_node: int = 16384) -> Vocabulary:
    """Hierarchical binary k-medians.

    descriptors: [M, 32] uint8 training set. Pure numpy: the tree has
    sum(k^l) nodes (11,110 at k=10 L=4), and a device dispatch per
    k-medians iteration would make large trainings dispatch-bound;
    popcount-LUT numpy runs the full 10k-leaf training on the host. Each
    node's medians are fit on at most `max_per_node` sampled
    rows (assignment for SPLITTING always uses every row)."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, np.uint8)

    def kmedians(data: np.ndarray) -> np.ndarray:
        """Cluster data [m, 32] into k binary medians."""
        m = data.shape[0]
        if m == 0:
            return np.zeros((k, 32), np.uint8)
        fit = data if m <= max_per_node else \
            data[rng.choice(m, size=max_per_node, replace=False)]
        init = fit[rng.choice(fit.shape[0], size=min(k, fit.shape[0]),
                              replace=False)]
        centers = np.zeros((k, 32), np.uint8)
        centers[:init.shape[0]] = init
        bits = np.unpackbits(fit, axis=1).astype(np.int32)   # [m, 256]
        for _ in range(iters):
            assign = np.argmin(_ham_np(fit, centers), axis=1)
            votes = np.zeros((k, 256), np.int64)
            np.add.at(votes, assign, bits)
            counts = np.bincount(assign, minlength=k)[:, None]
            maj = votes * 2 > counts
            new_centers = np.packbits(maj.astype(np.uint8), axis=1)
            empty = counts[:, 0] == 0
            if empty.any():
                new_centers[empty] = fit[rng.choice(fit.shape[0],
                                                    size=int(empty.sum()))]
            if (new_centers == centers).all():
                return new_centers
            centers = new_centers
        return centers

    # Build level-major tree: at each level, split each node's data k ways.
    all_centers = []
    groups = [desc]
    for lv in range(levels):
        lvl_centers = np.zeros((len(groups), k, 32), np.uint8)
        next_groups = []
        for gi, g in enumerate(groups):
            c = kmedians(g)
            lvl_centers[gi] = c
            if lv < levels - 1:
                if g.shape[0] > 0:
                    a = np.argmin(_ham_np(g, c), axis=1)
                else:
                    a = np.zeros(0, np.int64)
                for ci in range(k):
                    next_groups.append(g[a == ci])
        all_centers.append(lvl_centers.reshape(-1, 32))
        groups = next_groups
    return Vocabulary(centers=jnp.asarray(np.concatenate(all_centers, axis=0)),
                      k=k, levels=levels)


@partial(jax.jit, static_argnums=(2, 3))
def transform(desc: jnp.ndarray, centers: jnp.ndarray, k: int,
              levels: int) -> jnp.ndarray:
    """[N, 32] descriptors -> [N] leaf word ids (the DBoW2 `transform` walk)."""
    pm_d = orb_ops.descriptors_pm1(desc)                   # [N, 256]
    node = jnp.zeros(desc.shape[0], jnp.int32)             # node index within level
    for lv in range(levels):
        off = _node_offset(k, lv)
        child_ids = off + node[:, None] * k + jnp.arange(k)[None]  # [N, k]
        child_desc = centers[child_ids]                    # [N, k, 32]
        pm_c = orb_ops.descriptors_pm1(child_desc.reshape(-1, 32)).reshape(
            desc.shape[0], k, 256)
        dots = jnp.einsum("nc,nkc->nk", pm_d.astype(jnp.int32),
                          pm_c.astype(jnp.int32))
        best = jnp.argmax(dots, axis=1).astype(jnp.int32)  # max dot = min Hamming
        node = node * k + best
    return node


def bow_vector(words: jnp.ndarray, valid: jnp.ndarray, n_leaves: int) -> jnp.ndarray:
    """Word ids -> L1-normalized dense BoW vector [n_leaves]."""
    counts = jnp.zeros(n_leaves + 1).at[
        jnp.where(valid, words, n_leaves)].add(valid.astype(jnp.float32))
    v = counts[:n_leaves]
    return v / jnp.maximum(jnp.sum(v), 1e-9)


def l1_score(v: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity (ScoringObject): 1 - 0.5|v-w|_1, in [0, 1].

    Batched on leading dims of either argument.
    """
    return 1.0 - 0.5 * jnp.sum(jnp.abs(v - w), axis=-1)


def load_orbvoc_text(path: str) -> Vocabulary:
    """Load a DBoW2 text vocabulary (ORBvoc.txt — the file ORB-SLAM2 ships
    and the reference loads via TemplatedVocabulary::loadFromTextFile,
    TemplatedVocabulary.h:1338, System.cc:50-58).

    Format: header `k L scoring weighting`; then one node per line in
    parent-before-child order: `parent_id is_leaf d0..d31 weight`.

    DBoW2 trees can be INCOMPLETE (nodes with fewer than k children, leaves
    above depth L). This framework's `transform` walks a complete level-major
    k-ary array, so missing children inherit their parent's descriptor —
    the walk then lands on an equivalent leaf and word ids stay consistent
    within the framework (absolute DBoW2 word ids are not preserved; all
    consumers are in-framework)."""
    with open(path) as f:
        header = f.readline().split()
        k, levels = int(header[0]), int(header[1])
        parents: list[int] = [-1]        # node 0 = root
        descs: list[np.ndarray] = [np.zeros(32, np.uint8)]
        children: dict[int, list[int]] = {0: []}
        for line in f:
            parts = line.split()
            if len(parts) < 2 + 32:
                continue
            pid = int(parts[0])
            d = np.asarray([int(float(x)) for x in parts[2:2 + 32]], np.uint8)
            nid = len(parents)
            parents.append(pid)
            descs.append(d)
            children.setdefault(pid, []).append(nid)
            children.setdefault(nid, [])

    n_nodes = sum(k ** (l + 1) for l in range(levels))
    centers = np.zeros((n_nodes, 32), np.uint8)
    # BFS over the complete tree, tracking the real node each slot maps to.
    slot_real = [-1] * n_nodes          # real node id per complete slot
    off = 0
    # level 0: children of root
    root_kids = children.get(0, [])
    prev = []
    for i in range(k):
        real = root_kids[i] if i < len(root_kids) else -1
        slot = off + i
        slot_real[slot] = real
        centers[slot] = descs[real] if real >= 0 else descs[0]
        prev.append(slot)
    for lv in range(1, levels):
        off += k ** lv
        new_prev = []
        for pslot in prev:
            p_in_level = pslot - (off - k ** lv)
            real_p = slot_real[pslot]
            kids = children.get(real_p, []) if real_p >= 0 else []
            for i in range(k):
                slot = off + p_in_level * k + i
                real = kids[i] if i < len(kids) else -1
                slot_real[slot] = real
                centers[slot] = descs[real] if real >= 0 \
                    else centers[pslot]   # inherit: walk stays consistent
                new_prev.append(slot)
        prev = new_prev
    return Vocabulary(centers=jnp.asarray(centers), k=k, levels=levels)


def save(vocab: Vocabulary, path: str) -> None:
    np.savez_compressed(path, centers=np.asarray(vocab.centers),
                        k=vocab.k, levels=vocab.levels)


def load(path: str) -> Vocabulary:
    z = np.load(path)
    return Vocabulary(centers=jnp.asarray(z["centers"]), k=int(z["k"]),
                      levels=int(z["levels"]))


def random_pose(rng: np.random.Generator) -> np.ndarray:
    """A random viewpoint inside the synthetic room (full yaw coverage, mild
    pitch/roll) — wide pose diversity for vocabulary training and
    place-recognition tests."""
    from gdslam_tpu.core import lie as _lie
    t = np.asarray([rng.uniform(-1.0, 1.0), rng.uniform(-0.6, 0.6),
                    rng.uniform(-0.9, 0.9)])
    rot = np.asarray([rng.uniform(-0.25, 0.25),
                      rng.uniform(0.0, 2 * np.pi),
                      rng.uniform(-0.15, 0.15)])
    R = np.asarray(_lie.se3_exp(jnp.concatenate(
        [jnp.zeros(3), jnp.asarray(rot, np.float32)])))[:3, :3]
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t            # camera stays inside the room box
    return T


def train_from_synthetic(k: int = 10, levels: int = 4, n_frames: int = 150,
                         seed: int = 0) -> Vocabulary:
    """Train a default vocabulary from the synthetic scene at DIVERSE random
    viewpoints (full yaw coverage of the enclosed room — a fixed forward
    trajectory samples only one texture region and the vocabulary aliases).

    k=10, levels=4 -> 10,000 leaves: small enough to ship/train in-repo,
    large enough that distinct scenes map to near-disjoint word sets (the
    reference's external ORBvoc.txt is k=10 L=6 ~ 1M leaves,
    TemplatedVocabulary.h:1338; neither repo ships it)."""
    from gdslam_tpu.config import CameraConfig, OrbConfig
    from gdslam_tpu.frontend import extractor
    from gdslam_tpu.io import synthetic

    cam = CameraConfig()
    cfg = OrbConfig()
    rng = np.random.default_rng(seed)
    descs = []
    for i in range(n_frames):
        T = jnp.asarray(random_pose(rng), jnp.float32)
        fr = synthetic.render(T, cam, False, 30.0, frame_idx=i)
        f = extractor.extract(fr.gray, cfg, cam.height, cam.width)
        descs.append(np.asarray(f.desc[np.asarray(f.valid)]))
    data = np.concatenate(descs, axis=0)
    return train(data, k=k, levels=levels, seed=seed)


def default_vocabulary() -> Vocabulary:
    """Load (or train + cache) the shipped default vocabulary (10k leaves;
    see tools/train_vocab.py to retrain)."""
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "vocab_default.npz")
    path = os.path.abspath(path)
    if os.path.exists(path):
        return load(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    v = train_from_synthetic()
    save(v, path)
    return v
