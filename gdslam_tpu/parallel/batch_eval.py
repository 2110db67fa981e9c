"""Multi-sequence data-parallel evaluation over a device mesh.

The reference has no distributed layer (SURVEY §2.3: one process, 3-4 POSIX
threads); scale-out here is the batched multi-sequence configuration
(BASELINE config 5): one TUM-style sequence per mesh slot, the FULL
per-frame tracking system — feature extraction, motion-model + local-map
tracking, the keyframe decision, keyframe/map-point insertion into a
per-slot map arena, and point culling — as ONE on-device program sharded
with `shard_map` over a 1-D `seq` axis. `jax.lax` collectives appear only
for metric reduction, so the single-sequence program compiles
collective-free while the batched program's one psum crosses the
devices (NVLink between the cards of one host).

Control flow that the host `Tracking` state machine does per frame
(initialized? tracking ok? need keyframe?) runs on-device with `lax.cond`:
when each mesh slot holds exactly one sequence (the intended operating
point) the conditionals stay REAL branches; with more sequences per device
the step is vmapped and conds lower to selects (both branches execute) —
correct, uniformly slower, documented.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from gdslam_tpu.backend import map_arena as ma
from gdslam_tpu.config import SlamConfig
from gdslam_tpu.frontend import extractor
from gdslam_tpu.frontend.frame import Frame, build_frame
from gdslam_tpu.masking.geomask import gd_step_core
from gdslam_tpu.system import tracking as trk


def make_mesh(n_devices: int | None = None, axis: str = "seq") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


class GdRing(NamedTuple):
    """Per-slot GD frame ring: the most recent R frames (oldest first) with
    their cached extractions, so gd_step_core can pair frame t with t-R
    (GeoMaskMaker's inter_frame_size pairing, GeoMaskMaker.cc:409-429)
    entirely on device."""

    gray: jnp.ndarray    # [R, H, W]
    depth: jnp.ndarray   # [R, H, W]
    feats: extractor.Features  # [R, N, ...]-leading stacked pytree
    count: jnp.ndarray   # int32: frames pushed so far


class SeqState(NamedTuple):
    """Full per-sequence tracker state, device-resident.

    The batched analogue of the host `Tracking` object: the map arena plus
    every scalar the keyframe decision needs (Tracking.cc:1306-1390),
    promoted to device scalars so the whole step is one XLA program."""

    arena: ma.MapArena
    last_frame: Frame
    last_T_cw: jnp.ndarray        # [4, 4]
    last_assoc: jnp.ndarray       # [N] int32
    velocity: jnp.ndarray         # [4, 4]
    has_velocity: jnp.ndarray     # bool
    initialized: jnp.ndarray      # bool
    lost: jnp.ndarray             # bool
    ref_kf: jnp.ndarray           # int32
    ref_kf_matches: jnp.ndarray   # int32
    frames_since_kf: jnp.ndarray  # int32
    frame_idx: jnp.ndarray        # int32 (doubles as the device timestamp)
    gd: GdRing | None = None      # present when the slot runs GD masking


def _empty_frame(n: int) -> Frame:
    return Frame(uv=jnp.zeros((n, 2)), uv_raw=jnp.zeros((n, 2)),
                 ur=-jnp.ones(n), depth=jnp.zeros(n),
                 level=jnp.zeros(n, jnp.int32), angle=jnp.zeros(n),
                 response=jnp.zeros(n), desc=jnp.zeros((n, 32), jnp.uint8),
                 valid=jnp.zeros(n, bool))


def _empty_feats(n: int) -> extractor.Features:
    return extractor.Features(
        uv=jnp.zeros((n, 2)), response=jnp.zeros(n), angle=jnp.zeros(n),
        level=jnp.zeros(n, jnp.int32), desc=jnp.zeros((n, 32), jnp.uint8),
        valid=jnp.zeros(n, bool))


def init_seq_state(cfg: SlamConfig, kmax: int = 64,
                   pmax: int = 8192, use_gd: bool = False) -> SeqState:
    n = cfg.orb.n_features
    gd = None
    if use_gd:
        R = cfg.geomask.inter_frame_size
        H, W = cfg.camera.height, cfg.camera.width
        gd = GdRing(
            gray=jnp.zeros((R, H, W)), depth=jnp.zeros((R, H, W)),
            feats=jax.tree.map(lambda x: jnp.repeat(x[None], R, axis=0),
                               _empty_feats(n)),
            count=jnp.asarray(0, jnp.int32))
    return SeqState(
        arena=ma.new_arena(kmax, pmax, n),
        last_frame=_empty_frame(n),
        last_T_cw=jnp.eye(4),
        last_assoc=-jnp.ones(n, jnp.int32),
        velocity=jnp.eye(4),
        has_velocity=jnp.asarray(False),
        initialized=jnp.asarray(False),
        lost=jnp.asarray(False),
        ref_kf=jnp.asarray(0, jnp.int32),
        ref_kf_matches=jnp.asarray(0, jnp.int32),
        frames_since_kf=jnp.asarray(0, jnp.int32),
        frame_idx=jnp.asarray(0, jnp.int32),
        gd=gd,
    )


def _ref_matches_after_insert(arena: ma.MapArena) -> jnp.ndarray:
    kf = arena.n_kf - 1
    min_obs = jnp.where(arena.n_kf > 2, 3, jnp.where(arena.n_kf == 2, 2, 1))
    return trk.ref_tracked_points(arena, kf, min_obs).astype(jnp.int32)


RELOC_CANDIDATES = 4  # recent keyframes tried per on-device relocalization


def device_relocalize(arena: ma.MapArena, frame, cfg: SlamConfig,
                      frame_idx: jnp.ndarray):
    """On-device relocalization (Relocalization, Tracking.cc:1670-1832) for
    the batched tracker: a lost mesh slot recovers WITHOUT host arbitration.

    Candidates are the RELOC_CANDIDATES most recent keyframes (the batched
    system has no per-slot BoW database; recent keyframes cover the common
    short-term-loss case exactly as the host fallback in
    Tracking._relocalize does). All candidates are descriptor-matched in one
    vmapped battery, the best by match count feeds a 2D-3D PnP RANSAC
    (PnPsolver semantics, Tracking.cc:1715), and the coarse pose is grown +
    refined against the local map (SearchByProjection growth + >=50-inlier
    acceptance, Tracking.cc:1784-1818).

    Returns (ok, T, assoc, n_inl, arena') — arena' carries the
    visible/found bookkeeping and must be adopted ONLY on acceptance.
    """
    from gdslam_tpu.backend import solvers
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    ids = arena.n_kf - 1 - jnp.arange(RELOC_CANDIDATES)
    ok_id = (ids >= 0) & arena.kf_valid[jnp.maximum(ids, 0)]
    rows = jnp.maximum(ids, 0)

    def match_one(kf_row, kf_ok):
        m_idx, n_m = trk._dense_ratio_matches(
            frame.desc, frame.valid,
            arena.kf_desc[kf_row], arena.kf_kp_valid[kf_row] & kf_ok)
        return m_idx, jnp.where(kf_ok, n_m, 0)

    m_idx_all, n_m_all = jax.vmap(match_one)(rows, ok_id)
    best = jnp.argmax(n_m_all)
    kf = rows[best]
    m_idx = m_idx_all[best]
    pt = arena.kf_obs[kf][jnp.maximum(m_idx, 0)]
    has_pt = (m_idx >= 0) & (pt >= 0) & arena.pt_valid[jnp.maximum(pt, 0)]
    pw = arena.pt_pos[jnp.maximum(pt, 0)]
    res = solvers.ransac_pnp(
        pw, frame.uv, has_pt, K, n_iters=128, min_inliers=10,
        px_threshold=5.991 ** 0.5,
        key=jax.random.fold_in(jax.random.PRNGKey(3), frame_idx))
    matched = has_pt & res.inliers
    from gdslam_tpu.backend import optimizer as opt_mod
    obs = opt_mod.PoseObs(
        pw=jnp.where(matched[:, None], pw, 0.0),
        uv=frame.uv, ur=frame.ur,
        inv_sigma2=1.0 / float(cfg.orb.scale_factor) ** (
            2.0 * frame.level.astype(jnp.float32)),
        valid=matched)
    T, inl, n_inl = opt_mod.pose_optimization(res.T, obs, K, cam.bf)
    assoc0 = jnp.where(inl & matched, pt, -1)
    arena2, T2, assoc2, n2 = trk.track_local_map(arena, frame, T, cfg, assoc0)
    ok = res.ok & (n_inl >= 10) & (n2 >= 50) & (jnp.sum(has_pt) >= 15)
    return ok, T2, assoc2, n2, arena2


def device_track_step(state: SeqState, gray: jnp.ndarray, depth: jnp.ndarray,
                      mask: jnp.ndarray, cfg: SlamConfig):
    """One frame of the FULL tracker as a pure device function.

    Mirrors `Tracking.process` (system/tracking.py) including
    StereoInitialization, motion-model + local-map tracking
    (track_frame_core), the RGB-D NeedNewKeyFrame rules, fuse + keyframe
    insertion + point culling, local BA at keyframe rate
    (LocalMapping.cc:81), and on-device relocalization for lost slots
    (state==LOST -> Relocalization ONLY, Tracking.cc:439-447,1670-1832) —
    the full per-slot system with no host arbitration.

    With a GdRing in the state (init_seq_state(use_gd=True)), the slot
    additionally runs the GD dense-scene-flow masker per frame — frame t
    paired with the ring's t-R entry, gd_step_core's pose RANSAC + flow +
    Mahalanobis map refining `mask` before tracking (the per-slot analogue
    of TrackRGBD_GD) — realizing BASELINE config 5 on DYNAMIC sequences.

    Returns (new_state, stats [4] int32 = n1, n_inl, n_kf, n_pt).
    """
    cam = cfg.camera
    feats = extractor.extract(gray, cfg.orb, cam.height, cam.width)
    if state.gd is not None:
        # module-level import (below) — importing inside the traced function
        # would run geomask/flow module init under the trace, where any
        # module-level jnp constant becomes a leaked tracer
        ring = state.gd
        warm = ring.count >= ring.gray.shape[0]
        key = jax.random.fold_in(jax.random.PRNGKey(7), state.frame_idx)
        ref_feats = jax.tree.map(lambda x: x[0], ring.feats)

        def run_gd(_):
            return gd_step_core(feats, gray, depth, mask, ring.gray[0],
                                ring.depth[0], ref_feats, key, cfg)

        # warm-up frames pass the semantic mask through (cc:171-175)
        mask = jax.lax.cond(warm, run_gd, lambda _: mask, None)
        state = state._replace(gd=GdRing(
            gray=jnp.concatenate([ring.gray[1:], gray[None]]),
            depth=jnp.concatenate([ring.depth[1:], depth[None]]),
            feats=jax.tree.map(
                lambda a, b: jnp.concatenate([a[1:], b[None]]),
                ring.feats, feats),
            count=ring.count + 1))
    frame = build_frame(feats, depth, mask, cam)
    ts = state.frame_idx.astype(jnp.float32)

    def do_init(st: SeqState):
        n_valid = jnp.sum(frame.valid)
        ok = (n_valid >= min(cfg.tracking.min_init_features,
                             cfg.orb.n_features // 2)) & \
             (jnp.sum(frame.valid & (frame.depth > 0)) >=
              min(100, cfg.orb.n_features // 4))

        def init(st: SeqState):
            arena, assoc = trk._insert_keyframe(
                st.arena, frame, jnp.eye(4),
                -jnp.ones(frame.uv.shape[0], jnp.int32), ts, cfg,
                max_depth=1e9)
            st = st._replace(
                arena=arena, last_frame=frame, last_T_cw=jnp.eye(4),
                last_assoc=assoc, initialized=jnp.asarray(True),
                ref_kf=jnp.asarray(0, jnp.int32),
                ref_kf_matches=_ref_matches_after_insert(arena),
                frames_since_kf=jnp.asarray(0, jnp.int32))
            return st

        st = jax.lax.cond(ok, init, lambda s: s, st)
        return st, jnp.zeros(2, jnp.int32)

    def do_reloc(st: SeqState):
        """LOST slots relocalize instead of tracking (Tracking.cc:439-447:
        `if state==LOST: bOK = Relocalization()`)."""
        ok, T2, assoc2, n2, arena2 = device_relocalize(
            st.arena, frame, cfg, st.frame_idx)

        def adopt(st: SeqState):
            # Velocity stays cleared (the host path sets velocity=None after
            # relocalization) — one frame of map search re-establishes it.
            return st._replace(arena=arena2, last_frame=frame, last_T_cw=T2,
                               last_assoc=assoc2,
                               has_velocity=jnp.asarray(False),
                               lost=jnp.asarray(False),
                               frames_since_kf=st.frames_since_kf + 1)

        st = jax.lax.cond(ok, adopt, lambda s: s, st)
        return st, jnp.stack([jnp.asarray(0, jnp.int32),
                              jnp.where(ok, n2, 0).astype(jnp.int32)])

    def do_track(st: SeqState):
        last = trk.FrameState(frame=st.last_frame, T_cw=st.last_T_cw,
                              assoc=st.last_assoc)
        arena, new_last, vel_new, _, stats = trk.track_frame_core(
            st.arena, last, st.velocity, st.has_velocity, frame, cfg,
            st.ref_kf)
        n1, n_inl, close_tracked, close_untracked = (
            stats[0], stats[1], stats[2], stats[3])
        ok = (n1 >= 10) & (n_inl >= 30)

        # NeedNewKeyFrame (Tracking.cc:1306-1390; RGB-D rules as in
        # Tracking._need_keyframe_stats, on-device).
        fsk = st.frames_since_kf + 1
        need_close = (close_tracked < 100) & (close_untracked > 70) & \
            ((fsk >= 3) | (n_inl < 40))
        c1a = fsk >= jnp.int32(cam.fps)
        c2 = ((n_inl < 0.75 * jnp.maximum(st.ref_kf_matches, 1)) |
              need_close) & (n_inl > 15)
        need_kf = ok & (c2 | (c1a & (n_inl > 15))) & \
            (arena.n_kf < arena.kmax - 1)

        def adopt(st: SeqState):
            st = st._replace(arena=arena, last_frame=frame,
                             last_T_cw=new_last.T_cw,
                             last_assoc=new_last.assoc, velocity=vel_new,
                             has_velocity=jnp.asarray(True),
                             lost=jnp.asarray(False), frames_since_kf=fsk)

            def with_kf(st: SeqState):
                assoc = trk.fuse_associate(st.arena, frame, new_last.T_cw,
                                           new_last.assoc, cfg)
                a2, assoc = trk._insert_keyframe(
                    st.arena, frame, new_last.T_cw, assoc, ts, cfg)
                a2 = trk.cull_points(a2)
                kf_id = a2.n_kf - 1

                def with_ba(a):
                    # Local BA at keyframe rate (LocalMapping.cc:81), fully
                    # on-device — the same 5+5 GN schedule keyframe_program
                    # uses in the single-sequence system.
                    from gdslam_tpu.backend import ba as ba_mod
                    prob = ba_mod.build_problem(a, kf_id, cfg)
                    a, _ = ba_mod.run_local_ba(a, prob, cfg, 5, 5)
                    return a

                a2 = jax.lax.cond(a2.n_kf >= 3, with_ba, lambda a: a, a2)
                return st._replace(
                    arena=a2, last_assoc=assoc,
                    last_T_cw=a2.kf_pose[kf_id],
                    ref_kf=kf_id.astype(jnp.int32),
                    ref_kf_matches=_ref_matches_after_insert(a2),
                    frames_since_kf=jnp.asarray(0, jnp.int32))

            return jax.lax.cond(need_kf, with_kf, lambda s: s, st)

        def mark_lost(st: SeqState):
            return st._replace(lost=jnp.asarray(True),
                               has_velocity=jnp.asarray(False))

        st = jax.lax.cond(ok, adopt, mark_lost, st)
        return st, jnp.stack([n1, n_inl]).astype(jnp.int32)

    def do_track_or_reloc(st: SeqState):
        return jax.lax.cond(st.lost, do_reloc, do_track, st)

    state, tstats = jax.lax.cond(state.initialized, do_track_or_reloc,
                                 do_init, state)
    state = state._replace(frame_idx=state.frame_idx + 1)
    stats = jnp.concatenate([
        tstats, jnp.stack([state.arena.n_kf,
                           jnp.minimum(state.arena.n_pt, 1 << 30)]
                          ).astype(jnp.int32)])
    return state, stats


def batched_track_step(cfg: SlamConfig, height: int, width: int, mesh: Mesh,
                       axis: str = "seq", kmax: int = 64, pmax: int = 8192,
                       local_batch: int = 1):
    """Build the sharded batched full-tracker step.

    Returns a jitted fn (states, grays, depths) -> (states, mean_inliers):
    states is a [B, ...]-leading SeqState pytree sharded over `axis`
    (B = n_devices * local_batch), mean_inliers a replicated scalar from the
    only collective, a `psum` (SURVEY §5 'distributed communication
    backend'). With local_batch == 1 the per-device step keeps its `lax.cond`
    branches un-vmapped (real branches, no select lowering).

    Per-slot dynamic masking: build the states with
    init_states(..., use_gd=True) — the GdRing in the state switches
    device_track_step into the GD path (semantic input mask stays all-ones;
    the scene-flow masker supplies the dynamic suppression, matching the
    GD CLI default of mask=None).
    """
    n_dev = mesh.devices.size
    if local_batch > 1:
        import warnings
        warnings.warn(
            "batched_track_step(local_batch>1): vmap lowers every lax.cond "
            "(init/reloc/keyframe) to selects, so ALL branches execute for "
            "ALL slots each frame — expect ~2-3x the per-frame device cost "
            "of the intended 1-sequence-per-device operating point.",
            stacklevel=2)

    def one(state, gray, depth):
        masks = jnp.ones((height, width))
        return device_track_step(state, gray, depth, masks, cfg)

    def step(states, grays, depths):
        if local_batch == 1:
            state1 = jax.tree.map(lambda x: x[0], states)
            new1, stats = one(state1, grays[0], depths[0])
            new_states = jax.tree.map(lambda x: x[None], new1)
            inls = stats[1][None]
        else:
            new_states, stats = jax.vmap(one)(states, grays, depths)
            inls = stats[:, 1]
        total = jax.lax.psum(jnp.sum(inls), axis)
        count = n_dev * local_batch
        return new_states, total / count

    spec = P(axis)
    # check_vma=False: lax.cond branches mix per-sequence (varying) values
    # with fresh constants (unvarying), which the VMA checker rejects even
    # though the program is a correct per-shard computation.
    sharded = jax.shard_map(step, mesh=mesh,
                            in_specs=(spec, spec, spec),
                            out_specs=(spec, P()),
                            check_vma=False)
    return jax.jit(sharded)


def init_states(batch: int, cfg: SlamConfig, kmax: int = 64,
                pmax: int = 8192, use_gd: bool = False) -> SeqState:
    """[batch]-leading SeqState (tile of the empty per-sequence state)."""
    tmpl = init_seq_state(cfg, kmax=kmax, pmax=pmax, use_gd=use_gd)
    return jax.tree.map(lambda x: jnp.repeat(x[None], batch, axis=0), tmpl)
