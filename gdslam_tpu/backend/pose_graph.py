"""Pose-graph (essential graph) optimization after loop closure.

Replaces Optimizer::OptimizeEssentialGraph (reference Optimizer.cc:997-1260):
vertices = all keyframe poses, edges = spanning tree + loop edges +
strong-covisibility edges (weight >= 100, minFeat Optimizer.cc:1022),
measurements = relative poses at graph-build time (loop edges carry the
Sim3/SE3 computed by the loop solver), 20 iterations.

For RGB-D the scale is fixed (Sim3Solver.h:20 bFixScale), so the graph is
optimized over SE3. Design: per-edge 6x6 Jacobian blocks come from
`jax.jacfwd` of the closed-form residual (exact, no hand-derived adjoints),
assembled into a dense [6K, 6K] normal matrix with scatter-adds and solved
with Cholesky — at K<=512 this is a 3072^2 dense solve.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gdslam_tpu.core import lie

_PREC = jax.lax.Precision.HIGHEST


class PoseGraphEdges(NamedTuple):
    i: jnp.ndarray        # [E] int32 vertex ids
    j: jnp.ndarray        # [E]
    T_meas: jnp.ndarray   # [E, 4, 4] measured T_i @ inv(T_j)
    weight: jnp.ndarray   # [E] float
    valid: jnp.ndarray    # [E] bool
    s_meas: jnp.ndarray = None  # [E] measured relative scale (Sim3 graph;
    #                             1.0 on tree/covis edges, loop solver scale
    #                             on loop edges). None for the SE3 graph.


def build_edges(kf_pose: jnp.ndarray, kf_valid: jnp.ndarray,
                kf_parent: jnp.ndarray, covis: jnp.ndarray,
                loop_i: jnp.ndarray, loop_j: jnp.ndarray,
                loop_T: jnp.ndarray, loop_valid: jnp.ndarray,
                covis_min: int = 100, max_covis_edges: int = 2048,
                loop_s: jnp.ndarray = None) -> PoseGraphEdges:
    """Collect spanning-tree + covisibility(>=100) + loop edges.

    loop_s: per-loop-edge measured relative scale; when given, the returned
    edges carry `s_meas` (1.0 on tree/covis edges) for the Sim3 graph."""
    K = kf_pose.shape[0]
    ids = jnp.arange(K)

    def rel(i, j):
        return kf_pose[i] @ lie.se3_inverse(kf_pose[j])

    # Spanning tree edges (child -> parent).
    tree_j = jnp.maximum(kf_parent, 0)
    tree_valid = kf_valid & (kf_parent >= 0)
    tree_T = jax.vmap(rel)(ids, tree_j)

    # Strong covisibility edges (upper triangle only).
    w = jnp.where(jnp.triu(jnp.ones_like(covis), 1) > 0, covis, 0)
    w = jnp.where(kf_valid[:, None] & kf_valid[None, :], w, 0)
    flat = w.reshape(-1)
    top_w, top_idx = jax.lax.top_k(flat, max_covis_edges)
    ci = top_idx // K
    cj = top_idx % K
    cvalid = top_w >= covis_min
    cT = jax.vmap(rel)(ci, cj)

    s_meas = None
    if loop_s is not None:
        s_meas = jnp.concatenate([
            jnp.ones(K), jnp.ones(max_covis_edges), loop_s])
    return PoseGraphEdges(
        i=jnp.concatenate([ids, ci, loop_i]),
        j=jnp.concatenate([tree_j, cj, loop_j]),
        T_meas=jnp.concatenate([tree_T, cT, loop_T], axis=0),
        weight=jnp.concatenate([
            jnp.ones(K), jnp.ones(max_covis_edges),
            jnp.full(loop_i.shape[0], 5.0)]),
        valid=jnp.concatenate([tree_valid, cvalid, loop_valid]),
        s_meas=s_meas,
    )


def _edge_residual(xi_i, xi_j, T_i0, T_j0, T_meas):
    T_i = lie.se3_exp(xi_i) @ T_i0
    T_j = lie.se3_exp(xi_j) @ T_j0
    return lie.se3_log(lie.se3_inverse(T_meas) @ (T_i @ lie.se3_inverse(T_j)))


@partial(jax.jit, static_argnums=(3,))
def optimize(kf_pose: jnp.ndarray, kf_valid: jnp.ndarray,
             edges: PoseGraphEdges, iters: int = 20,
             fixed_id: int = 0, damping: float = 1e-6) -> jnp.ndarray:
    """Run GN on the pose graph; returns updated [K, 4, 4] poses."""
    K = kf_pose.shape[0]

    res_fn = jax.vmap(_edge_residual)
    Ji_fn = jax.vmap(jax.jacfwd(_edge_residual, argnums=0))
    Jj_fn = jax.vmap(jax.jacfwd(_edge_residual, argnums=1))
    zero6 = jnp.zeros((edges.i.shape[0], 6))

    def gn_iter(_, poses):
        Ti0 = poses[edges.i]
        Tj0 = poses[edges.j]
        r = res_fn(zero6, zero6, Ti0, Tj0, edges.T_meas)       # [E, 6]
        Ji = Ji_fn(zero6, zero6, Ti0, Tj0, edges.T_meas)       # [E, 6, 6]
        Jj = Jj_fn(zero6, zero6, Ti0, Tj0, edges.T_meas)
        w = edges.weight * edges.valid
        H = jnp.zeros((K, 6, K, 6))
        b = jnp.zeros((K, 6))

        def blk(Ja, Jb):
            return jnp.einsum("eri,e,erj->eij", Ja, w, Jb, precision=_PREC)

        H = H.at[edges.i, :, edges.i, :].add(blk(Ji, Ji))
        H = H.at[edges.j, :, edges.j, :].add(blk(Jj, Jj))
        H = H.at[edges.i, :, edges.j, :].add(blk(Ji, Jj))
        H = H.at[edges.j, :, edges.i, :].add(blk(Jj, Ji))
        b = b.at[edges.i].add(jnp.einsum("eri,e,er->ei", Ji, w, r,
                                         precision=_PREC))
        b = b.at[edges.j].add(jnp.einsum("eri,e,er->ei", Jj, w, r,
                                         precision=_PREC))
        # Fix gauge + padded vertices: identity rows.
        free = kf_valid & (jnp.arange(K) != fixed_id)
        Hm = H.reshape(6 * K, 6 * K)
        mask = jnp.repeat(free, 6)
        Hm = jnp.where(mask[:, None] & mask[None, :], Hm, 0.0)
        Hm = Hm + jnp.diag(jnp.where(mask, damping, 1.0))
        bv = jnp.where(mask, b.reshape(-1), 0.0)
        dx = -jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Hm), bv)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0).reshape(K, 6)
        return jax.vmap(lambda x, T: lie.se3_exp(x) @ T)(dx, poses)

    out = jax.lax.fori_loop(0, iters, gn_iter, kf_pose)
    return lie.se3_orthonormalize(out)


# ----------------------------------------------------------------------------
# Sim3 essential graph (monocular scale-drift correction)
# ----------------------------------------------------------------------------

def _sim3_edge_residual(xi_i, xi_j, Ri0, ti0, si0, Rj0, tj0, sj0,
                        Rm, tm, sm):
    """r = sim3_log(S_meas^-1 o S_i o S_j^-1) in R^7 with S_i/S_j perturbed
    left-multiplicatively — the 7-dof twin of _edge_residual
    (g2o EdgeSim3 computeError, used by Optimizer.cc:997-1260)."""
    dRi, dti, dsi = lie.sim3_exp(xi_i)
    Ri, ti, si = lie.sim3_compose(dRi, dti, dsi, Ri0, ti0, si0)
    dRj, dtj, dsj = lie.sim3_exp(xi_j)
    Rj, tj, sj = lie.sim3_compose(dRj, dtj, dsj, Rj0, tj0, sj0)
    Rji, tji, sji = lie.sim3_compose(
        Ri, ti, si, *lie.sim3_inverse(Rj, tj, sj))
    Rmi, tmi, smi = lie.sim3_inverse(Rm, tm, sm)
    Re, te, se = lie.sim3_compose(Rmi, tmi, smi, Rji, tji, sji)
    return lie.sim3_log(Re, te, se)


@partial(jax.jit, static_argnums=(5, 6))
def optimize_sim3_graph(R0: jnp.ndarray, t0: jnp.ndarray, s0: jnp.ndarray,
                        kf_valid: jnp.ndarray, edges: PoseGraphEdges,
                        fix_scale: bool = False, iters: int = 20,
                        fixed_id: int = 0, damping: float = 1e-6):
    """Essential-graph GN over Sim3 vertices (Optimizer.cc:997-1260 /
    types_seven_dof_expmap): monocular scale drift distributes around the
    loop through the per-vertex scale. Vertices are S_iw = (R, t, s); edge
    measurements are relative Sim3 (scale 1 on tree/covis edges — their
    relative scale at build time — and the loop solver's scale on loop
    edges, carried in edges.s_meas).

    fix_scale=True freezes every sigma (bFixScale, Sim3Solver.h:20): the
    graph then reduces exactly to the SE3 essential graph.

    Returns (R [K,3,3], t [K,3], s [K])."""
    K = R0.shape[0]
    s_meas = edges.s_meas if edges.s_meas is not None \
        else jnp.ones(edges.i.shape[0])

    res_fn = jax.vmap(_sim3_edge_residual)
    Ji_fn = jax.vmap(jax.jacfwd(_sim3_edge_residual, argnums=0))
    Jj_fn = jax.vmap(jax.jacfwd(_sim3_edge_residual, argnums=1))
    zero7 = jnp.zeros((edges.i.shape[0], 7))

    def gn_iter(_, state):
        R, t, s = state
        args = (R[edges.i], t[edges.i], s[edges.i],
                R[edges.j], t[edges.j], s[edges.j],
                edges.T_meas[:, :3, :3], edges.T_meas[:, :3, 3], s_meas)
        r = res_fn(zero7, zero7, *args)                        # [E, 7]
        Ji = Ji_fn(zero7, zero7, *args)                        # [E, 7, 7]
        Jj = Jj_fn(zero7, zero7, *args)
        if fix_scale:
            Ji = Ji.at[..., 6].set(0.0)
            Jj = Jj.at[..., 6].set(0.0)
        w = edges.weight * edges.valid
        H = jnp.zeros((K, 7, K, 7))
        b = jnp.zeros((K, 7))

        def blk(Ja, Jb):
            return jnp.einsum("eri,e,erj->eij", Ja, w, Jb, precision=_PREC)

        H = H.at[edges.i, :, edges.i, :].add(blk(Ji, Ji))
        H = H.at[edges.j, :, edges.j, :].add(blk(Jj, Jj))
        H = H.at[edges.i, :, edges.j, :].add(blk(Ji, Jj))
        H = H.at[edges.j, :, edges.i, :].add(blk(Jj, Ji))
        b = b.at[edges.i].add(jnp.einsum("eri,e,er->ei", Ji, w, r,
                                         precision=_PREC))
        b = b.at[edges.j].add(jnp.einsum("eri,e,er->ei", Jj, w, r,
                                         precision=_PREC))
        free = kf_valid & (jnp.arange(K) != fixed_id)
        mask = jnp.repeat(free, 7)
        if fix_scale:
            mask = mask & (jnp.tile(jnp.arange(7), K) != 6)
        Hm = H.reshape(7 * K, 7 * K)
        Hm = jnp.where(mask[:, None] & mask[None, :], Hm, 0.0)
        Hm = Hm + jnp.diag(jnp.where(mask, damping, 1.0))
        bv = jnp.where(mask, b.reshape(-1), 0.0)
        dx = -jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Hm), bv)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0).reshape(K, 7)
        dR, dt, ds = jax.vmap(lie.sim3_exp)(dx)
        return jax.vmap(lie.sim3_compose)(dR, dt, ds, R, t, s)

    R, t, s = jax.lax.fori_loop(0, iters, gn_iter, (R0, t0, s0))
    return lie.so3_project(R), t, s
