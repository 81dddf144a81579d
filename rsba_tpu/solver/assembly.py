"""Gradient / normal-equation assembly from batched block Jacobians.

Parity: Ceres's block-sparse ``Program`` storage and per-thread accumulation
(SURVEY.md §2 C12, §2.9 P1/P3), as segment-sums over the observation axis —
the batched replacement for scatter-by-thread.

Tangent vector layout (flat): ``[poses (P·6) | intrinsics (K·ni) | points
(M·3)]``.  The camera part (poses+intrinsics) is the Schur "camera" group;
points are the eliminated group.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..problem.types import POSE_DOF, Params, Problem
from .residuals import Evaluation


class TangentShapes(NamedTuple):
    n_poses: int
    n_intr: int
    ni: int
    n_points: int

    @property
    def cam_dim(self) -> int:
        return self.n_poses * POSE_DOF + self.n_intr * self.ni

    @property
    def point_dim(self) -> int:
        return self.n_points * 3

    @property
    def total_dim(self) -> int:
        return self.cam_dim + self.point_dim


def tangent_shapes(problem: Problem, params: Params) -> TangentShapes:
    return TangentShapes(params.n_poses, params.intr.shape[0],
                         problem.intr_tangent_dim, params.n_points)


def unflatten_tangent(x: jax.Array, shapes: TangentShapes):
    """Flat tangent vector → (d_pose (P,6), d_intr (K,ni), d_pt (M,3))."""
    p6 = shapes.n_poses * POSE_DOF
    kni = shapes.n_intr * shapes.ni
    d_pose = x[:p6].reshape(shapes.n_poses, POSE_DOF)
    d_intr = x[p6:p6 + kni].reshape(shapes.n_intr, shapes.ni)
    d_pt = x[p6 + kni:].reshape(shapes.n_points, 3)
    return d_pose, d_intr, d_pt


def flatten_tangent(d_pose, d_intr, d_pt) -> jax.Array:
    return jnp.concatenate(
        [d_pose.reshape(-1), d_intr.reshape(-1), d_pt.reshape(-1)])


def gradient_blocks(ev: Evaluation, problem: Problem,
                    shapes: TangentShapes):
    """g = J̃ᵀ r̃ per block: (P,6), (K,ni), (M,3)."""
    obs = problem.obs
    g_pose = jnp.zeros((shapes.n_poses, POSE_DOF), ev.r.dtype)
    for s, idx in ((0, obs.pose_a), (1, obs.pose_b)):
        contrib = jnp.einsum("nrd,nr->nd", ev.J_pose[:, :, s, :], ev.r)
        g_pose = g_pose.at[idx].add(contrib)
    if shapes.ni > 0:
        g_intr = jax.ops.segment_sum(
            jnp.einsum("nrd,nr->nd", ev.J_intr, ev.r), obs.intr_idx,
            num_segments=shapes.n_intr)
    else:
        g_intr = jnp.zeros((shapes.n_intr, 0), ev.r.dtype)
    g_pt = jax.ops.segment_sum(
        jnp.einsum("nrd,nr->nd", ev.J_pt, ev.r), obs.point,
        num_segments=shapes.n_points)
    return g_pose, g_intr, g_pt


def point_hessian_blocks(ev: Evaluation, problem: Problem,
                         shapes: TangentShapes) -> jax.Array:
    """C (M,3,3): per-point Gauss-Newton blocks Σ J_ptᵀ J_pt."""
    contrib = jnp.einsum("nrd,nre->nde", ev.J_pt, ev.J_pt)
    return jax.ops.segment_sum(contrib, problem.obs.point,
                               num_segments=shapes.n_points)


def jtj_diagonal_blocks(ev: Evaluation, problem: Problem,
                        shapes: TangentShapes):
    """diag(J̃ᵀJ̃) per block — for LM damping and Jacobi scaling."""
    obs = problem.obs
    d_pose = jnp.zeros((shapes.n_poses, POSE_DOF), ev.r.dtype)
    for s, idx in ((0, obs.pose_a), (1, obs.pose_b)):
        d_pose = d_pose.at[idx].add(
            jnp.sum(ev.J_pose[:, :, s, :] ** 2, axis=1))
    if shapes.ni > 0:
        d_intr = jax.ops.segment_sum(jnp.sum(ev.J_intr ** 2, axis=1),
                                     obs.intr_idx, num_segments=shapes.n_intr)
    else:
        d_intr = jnp.zeros((shapes.n_intr, 0), ev.r.dtype)
    d_pt = jax.ops.segment_sum(jnp.sum(ev.J_pt ** 2, axis=1), obs.point,
                               num_segments=shapes.n_points)
    return d_pose, d_intr, d_pt


# --- Dense-oracle path (small problems; cross-check for the Schur path) ----

def dense_jacobian(ev: Evaluation, problem: Problem,
                   shapes: TangentShapes) -> jax.Array:
    """Materialize the full dense Jacobian (N·2, D).

    Only for small problems — the internal correctness oracle mirroring
    Ceres's ``schur_eliminator_test`` explicit-dense cross-check
    (SURVEY.md §4.1/§4.2 item 3).
    """
    obs = problem.obs
    N = ev.n_obs
    D = shapes.total_dim
    p6 = shapes.n_poses * POSE_DOF
    kni = shapes.n_intr * shapes.ni
    rows = jnp.arange(N)[:, None, None]
    rdim = jnp.arange(2)[None, :, None]
    Jd = jnp.zeros((N, 2, D), ev.r.dtype)

    def put(Jd, Jb, cols):
        return Jd.at[rows, rdim, cols[:, None, :]].add(Jb)

    ar6 = jnp.arange(POSE_DOF)[None, :]
    Jd = put(Jd, ev.J_pose[:, :, 0, :], obs.pose_a[:, None] * POSE_DOF + ar6)
    Jd = put(Jd, ev.J_pose[:, :, 1, :], obs.pose_b[:, None] * POSE_DOF + ar6)
    if shapes.ni > 0:
        Jd = put(Jd, ev.J_intr,
                 p6 + obs.intr_idx[:, None] * shapes.ni
                 + jnp.arange(shapes.ni)[None, :])
    Jd = put(Jd, ev.J_pt,
             p6 + kni + obs.point[:, None] * 3 + jnp.arange(3)[None, :])
    return Jd.reshape(N * 2, D)


def dense_normal_equations(ev: Evaluation, problem: Problem,
                           shapes: TangentShapes):
    """(H, g) fully dense — H = J̃ᵀJ̃ (D,D), g = J̃ᵀr̃ (D,)."""
    Jd = dense_jacobian(ev, problem, shapes)
    H = Jd.T @ Jd
    g = Jd.T @ ev.r.reshape(-1)
    return H, g
