"""Visibility-clustered block preconditioner for the flat PCG path.

Parity: Ceres ``CLUSTER_JACOBI`` (SURVEY.md §2 C16) — cluster the camera
co-visibility graph, keep the reduced camera system S restricted to the
cluster-diagonal, factor each cluster block dense, apply as a batched
block solve inside PCG.  The banded engine's ``cluster_jacobi``
(contiguous trajectory segments, solver/banded.py) is the video special
case; THIS module is the general tier for unordered problems (BAL-style)
on ``iterative_schur`` — VERDICT r4 missing #3.

Construction is batched throughout:

* host (once per solver): greedy size-capped agglomeration over the
  co-visibility edge weights; enumeration of same-point observation
  pairs whose cameras share a cluster; a PairPlan grouping those pairs
  by (pose_i, pose_k).
* device (once per solve_step): the cluster blocks
  S_c[p, q] = δ_pq·(B_pp + λ) − Σ_j F_jp C_jλ⁻¹ F_jqᵀ are assembled as
  column components (observation axis minor — see schur._col_products'
  layout note), reduced by the pair plan, placed with unique indices
  into (n_clusters, D_max, D_max) batched blocks, and Cholesky-factored
  in one batched call.

The per-pose diagonal (p == q) terms are exactly the SCHUR_JACOBI blocks
(pcg.schur_jacobi_partial); clustering adds the within-cluster
off-diagonal coupling that plain Schur-Jacobi drops.  Intrinsics blocks
keep their own Schur-Jacobi treatment (Ceres clusters cameras only).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..problem.types import POSE_DOF, Problem
from . import flatplan

#: symmetric 3×3 packed index for (p, q)
_SYM = {(0, 0): 0, (0, 1): 1, (1, 0): 1, (0, 2): 2, (2, 0): 2,
        (1, 1): 3, (1, 2): 4, (2, 1): 4, (2, 2): 5}
_SYM6 = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def cluster_cameras(problem: Problem, point_plan: flatplan.GroupPlan,
                    max_size: int = 8) -> np.ndarray:
    """(P,) cluster id per pose — greedy co-visibility agglomeration.

    Edges weighted by the number of points two cameras co-observe
    (counted over the point grouping's slot pairs); merged heaviest
    first under a ``max_size`` cap — the standard greedy stand-in for
    Ceres's canonical-views clustering.
    """
    P = int(problem.pose_free.shape[0])
    N = point_plan.n_obs
    pa = np.asarray(problem.obs.pose_a)
    slots = np.asarray(point_plan.slots)
    cam = np.concatenate([pa, [-1]])[np.minimum(slots, N)]      # (R, L)
    L = cam.shape[1]
    il, ik = np.triu_indices(L, 1)
    ci = cam[:, il].ravel()
    ck = cam[:, ik].ravel()
    ok = (ci >= 0) & (ck >= 0) & (ci != ck)
    lo = np.minimum(ci[ok], ck[ok])
    hi = np.maximum(ci[ok], ck[ok])
    edge_ids, weights = np.unique(lo.astype(np.int64) * P + hi,
                                  return_counts=True)
    order = np.argsort(-weights)
    parent = np.arange(P)
    size = np.ones(P, np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in edge_ids[order]:
        a, b = find(int(e // P)), find(int(e % P))
        if a != b and size[a] + size[b] <= max_size:
            parent[b] = a
            size[a] += size[b]
    roots = np.array([find(i) for i in range(P)])
    _, ids = np.unique(roots, return_inverse=True)
    return ids


class ClusterPlan(NamedTuple):
    """Everything the solve-step assembly needs, built once."""
    cluster_of: jax.Array        # (P,) int32
    local_of: jax.Array          # (P,) int32 — pose slot within cluster
    n_clusters: int
    max_poses: int               # largest cluster (pose count)
    #: same-point obs pairs with co-clustered cameras
    pair_i: jax.Array            # (NP,) int32 obs index
    pair_k: jax.Array            # (NP,) int32 obs index
    pair_point: jax.Array        # (NP,) int32
    pairs: flatplan.PairPlan     # grouped by (pose_i, pose_k)
    pose_table: jax.Array        # (n_clusters, max_poses) pose id; P = pad


def build_cluster_plan(problem: Problem, point_plan: flatplan.GroupPlan,
                       max_size: int = 8) -> ClusterPlan:
    ids = cluster_cameras(problem, point_plan, max_size)
    P = ids.shape[0]
    n_c = int(ids.max()) + 1 if ids.size else 1
    local = np.zeros(P, np.int64)
    counts = np.zeros(n_c, np.int64)
    for p in range(P):
        local[p] = counts[ids[p]]
        counts[ids[p]] += 1
    max_poses = int(counts.max()) if n_c else 1

    N = point_plan.n_obs
    pa = np.asarray(problem.obs.pose_a)
    pt = np.asarray(problem.obs.point)
    slots = np.asarray(point_plan.slots)
    L = slots.shape[1]
    il, ik = np.triu_indices(L, 1)
    oi = slots[:, il].ravel()
    ok_ = slots[:, ik].ravel()
    valid = (oi < N) & (ok_ < N)
    oi, ok_ = oi[valid], ok_[valid]
    same = ids[pa[oi]] == ids[pa[ok_]]
    diff_pose = pa[oi] != pa[ok_]
    keep = same & diff_pose
    oi, ok_ = oi[keep], ok_[keep]
    pairs = flatplan.build_pair_plan(pa[oi], pa[ok_],
                                     int(problem.pose_free.shape[0]))
    table = np.full((n_c, max_poses), P, np.int64)
    table[ids, local] = np.arange(P)
    return ClusterPlan(
        cluster_of=jnp.asarray(ids, jnp.int32),
        local_of=jnp.asarray(local, jnp.int32),
        n_clusters=n_c, max_poses=max_poses,
        pair_i=jnp.asarray(oi, jnp.int32),
        pair_k=jnp.asarray(ok_, jnp.int32),
        pair_point=jnp.asarray(pt[oi], jnp.int32),
        pairs=pairs,
        pose_table=jnp.asarray(table, jnp.int32))


def cluster_blocks(cp: ClusterPlan, D_pose: jax.Array, ev, problem: Problem,
                   C_inv: jax.Array) -> jax.Array:
    """(n_clusters, D, D) dense cluster blocks of S_λ.

    D_pose: the damped per-pose Schur-Jacobi diagonal blocks (P, 6, 6) —
    placed on each cluster block's diagonal.  The off-diagonal coupling
    −Σ_j F_jp C_jλ⁻¹ F_jqᵀ is assembled from the same-point pair list.
    """
    D = cp.max_poses * POSE_DOF
    mp = cp.max_poses
    dt = D_pose.dtype
    c_of = cp.cluster_of

    # Diagonal per-pose blocks — scatter-free placement (chained
    # `.at[].add` placements were observed to miscompile on the
    # accelerator this path was first built for; see
    # flatcols._diag_embed): reduce per (cluster, slot) via one-hot
    # matmul, then broadcast against an identity slot mask.
    slot_id = c_of * mp + cp.local_of                          # (P,)
    ohs = jax.nn.one_hot(slot_id, cp.n_clusters * mp, dtype=dt)
    T = jnp.einsum("ps,pwv->swv", ohs,
                   jax.lax.optimization_barrier(D_pose))
    T = T.reshape(cp.n_clusters, mp, POSE_DOF, POSE_DOF)
    eye = jnp.eye(mp, dtype=dt)
    out = (T[:, :, :, None, :]
           * eye[None, :, None, :, None]).reshape(cp.n_clusters, D, D)

    # Off-diagonal −F C⁻¹ Fᵀ for co-clustered camera pairs.
    if cp.pair_i.shape[0] > 0:
        Jp = ev.J_pt
        Ja = ev.J_pose[:, :, 0, :]
        nr = Ja.shape[1]
        # F columns per obs: f[w][p] = Σ_r J[:,r,w]·Jp[:,r,p]  (18 × (N,))
        f = [[sum(Ja[:, r, w] * Jp[:, r, p] for r in range(nr))
              for p in range(3)] for w in range(POSE_DOF)]
        fi = [[col[cp.pair_i] for col in row] for row in f]
        fk = [[col[cp.pair_k] for col in row] for row in f]
        ci_flat = C_inv.reshape(C_inv.shape[0], 9)
        ci = [ci_flat[:, 3 * p + q][cp.pair_point]
              for (p, q) in _SYM6]
        comps = []
        for w in range(POSE_DOF):
            for v in range(POSE_DOF):
                comps.append(-sum(
                    fi[w][p] * ci[_SYM[(p, q)]] * fk[v][q]
                    for p in range(3) for q in range(3)))
        blocks = cp.pairs.group.reduce_cols(
            jnp.stack(comps, axis=0)).reshape(-1, POSE_DOF, POSE_DOF)
        # Unique (pose_i, pose_k) placement + transpose (S symmetric) —
        # scatter-free: three-way one-hot contraction over unique pairs.
        pi, pk = cp.pairs.pos_i, cp.pairs.pos_k
        ohc = jax.nn.one_hot(c_of[pi], cp.n_clusters, dtype=dt)
        ohi = jax.nn.one_hot(cp.local_of[pi], mp, dtype=dt)
        ohk = jax.nn.one_hot(cp.local_of[pk], mp, dtype=dt)
        cross = jnp.einsum("uc,ul,um,uwv->clwmv", ohc, ohi, ohk,
                           jax.lax.optimization_barrier(blocks))
        cross = cross.reshape(cp.n_clusters, D, D)
        out = out + cross + jnp.swapaxes(cross, -1, -2)

    # Pad unused slots with identity rows so the batched Cholesky is PD.
    occupied = jnp.zeros((cp.n_clusters, cp.max_poses), D_pose.dtype)
    occupied = occupied.at[c_of, cp.local_of].set(1.0)
    slot_live = jnp.repeat(occupied, POSE_DOF, axis=1)         # (n_c, D)
    out = out + jnp.eye(D, dtype=D_pose.dtype)[None] * (
        1.0 - slot_live)[:, :, None]
    return out


def make_cluster_preconditioner(cp: ClusterPlan, D_pose, D_intr, shapes,
                                ev, problem, C_inv):
    """M⁻¹ apply for PCG: batched cluster-block solves (+ intr blocks)."""
    blocks = cluster_blocks(cp, D_pose, ev, problem, C_inv)
    Lc = jax.vmap(jnp.linalg.cholesky)(blocks)
    ni = shapes.ni
    L_intr = (jax.vmap(jnp.linalg.cholesky)(D_intr) if ni > 0 else None)
    p6 = shapes.n_poses * POSE_DOF
    D = cp.max_poses * POSE_DOF

    def apply(r: jax.Array) -> jax.Array:
        rp = r[:p6].reshape(shapes.n_poses, POSE_DOF)
        # gather-based pack/unpack (scatter-free; see cluster_blocks)
        ext = jnp.concatenate(
            [rp, jnp.zeros((1, POSE_DOF), r.dtype)], axis=0)
        rc = ext[cp.pose_table].reshape(cp.n_clusters, D)
        zc = jax.vmap(
            lambda L, b: jax.scipy.linalg.cho_solve((L, True), b))(Lc, rc)
        zp = zc.reshape(cp.n_clusters, cp.max_poses, POSE_DOF)[
            cp.cluster_of, cp.local_of].reshape(-1)
        if ni > 0:
            ri = r[p6:].reshape(shapes.n_intr, ni)
            zi = jax.vmap(
                lambda L, b: jax.scipy.linalg.cho_solve((L, True), b))(
                    L_intr, ri).reshape(-1)
            return jnp.concatenate([zp, zi])
        return zp

    return apply
