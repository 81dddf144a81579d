"""Batched residual + Jacobian evaluation — the framework's Evaluator.

Parity: Ceres ``ProgramEvaluator`` + ``AutoDiffCostFunction`` (SURVEY.md §2
C7/C8/C11, §3.3).  Where Ceres fans threads out over residual blocks and
propagates ``Jet`` duals through a templated functor, we evaluate **all
observations as one batched jax computation**: `jax.jacfwd` over the 18+ni
tangent coordinates of a single observation, `vmap`'d over the observation
axis — vector lanes replace threads (SURVEY.md §2.9 P1).

Jacobians are taken in **tangent space** directly (pose ⊞ δ with the
quaternion manifold, intrinsics through the static basis), so downstream
algebra never sees the 4-dof quaternion ambient space — this folds Ceres's
``Manifold::PlusJacobian`` chain-rule step into the autodiff pass.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..geometry import camera, quaternion as quat
from ..problem.types import POSE_DOF, Observations, Params, Problem
from ..pytree import pytree_dataclass


@pytree_dataclass
class Evaluation:
    """Robust-corrected, masked residuals and block Jacobians."""
    r: jax.Array                    # (N, 2) corrected residuals
    cost: jax.Array                 # scalar: ½ Σ mask·ρ(‖r‖²)
    J_pose: Optional[jax.Array]     # (N, 2, 2, 6) for (pose_a, pose_b)
    J_intr: Optional[jax.Array]     # (N, 2, ni)
    J_pt: Optional[jax.Array]       # (N, 2, 3)

    @property
    def n_obs(self) -> int:
        return self.r.shape[0]


def _gathered_residual_fn(problem: Problem):
    """Per-observation tangent-space residual closure.

    Returns f(d_pa, d_pb, d_intr, d_pt, gathered...) -> (2,) residual, where
    the d_* are tangent perturbations evaluated at zero.
    """
    model = problem.model
    basis = problem.intr_basis

    def f(d_pa, d_pb, d_intr, d_pt, qa, ca, qb, cb, intr, X, uv, t):
        qa2 = quat.boxplus(qa, d_pa[:3])
        ca2 = ca + d_pa[3:]
        qb2 = quat.boxplus(qb, d_pb[:3])
        cb2 = cb + d_pb[3:]
        intr2 = intr + basis @ d_intr
        X2 = X + d_pt
        return camera.project(qa2, ca2, qb2, cb2, intr2, X2, t, model) - uv

    return f


def _gather(params: Params, obs: Observations):
    qa = params.q[obs.pose_a]
    ca = params.c[obs.pose_a]
    qb = params.q[obs.pose_b]
    cb = params.c[obs.pose_b]
    intr = params.intr[obs.intr_idx]
    X = params.points[obs.point]
    return qa, ca, qb, cb, intr, X


def residuals_raw(params: Params, problem: Problem) -> jax.Array:
    """(N, 2) uncorrected, unmasked reprojection residuals."""
    obs = problem.obs
    qa, ca, qb, cb, intr, X = _gather(params, obs)
    proj = camera.project(qa, ca, qb, cb, intr, X, obs.t, problem.model)
    return proj - obs.uv


def cost_only(params: Params, problem: Problem) -> jax.Array:
    """Robustified total cost ½ Σ mask·ρ(‖r‖²) — the accept/reject metric."""
    r = residuals_raw(params, problem)
    s = jnp.sum(r * r, axis=-1)
    rho, _, _ = problem.loss.evaluate(s)
    return 0.5 * jnp.sum(problem.obs.mask * rho)


def squared_pixel_error(params: Params, problem: Problem) -> jax.Array:
    """Σ mask·‖r‖² (unrobustified) — numerator of the reprojection RMSE."""
    r = residuals_raw(params, problem)
    return jnp.sum(problem.obs.mask * jnp.sum(r * r, axis=-1))


def cost_decrease(params_old: Params, params_new: Params,
                  problem: Problem) -> jax.Array:
    """½ Σ mask·(ρ_old − ρ_new), summed PAIRWISE per observation.

    In f32 the total cost's ulp can exceed a near-convergence
    step's true decrease (robust problems sit on a large outlier-cost
    plateau); differencing per-observation before reducing keeps the
    error at ~√N·ulp(ρ_i) instead of ulp(Σρ) — the compensated-reduction
    tactic of SURVEY.md §7.2 item 1.  Used for the trust-region ρ and
    function-tolerance tests.
    """
    r_old = residuals_raw(params_old, problem)
    r_new = residuals_raw(params_new, problem)
    rho_old, _, _ = problem.loss.evaluate(jnp.sum(r_old * r_old, axis=-1))
    rho_new, _, _ = problem.loss.evaluate(jnp.sum(r_new * r_new, axis=-1))
    return 0.5 * jnp.sum(problem.obs.mask * (rho_old - rho_new))


def error_stats(params: Params, problem: Problem, inlier_threshold: float):
    """(Σ‖r‖², n, Σ_inlier‖r‖², n_inlier) over valid observations.

    Inlier = ‖r‖ ≤ inlier_threshold (px).  With robust losses the plain
    RMSE is dominated by outlier tracks; the inlier RMSE is the
    reprojection-accuracy metric comparable across solvers
    (BASELINE.json "final reprojection RMSE").
    """
    r = residuals_raw(params, problem)
    s = jnp.sum(r * r, axis=-1)
    m = problem.obs.mask
    inl = m * (s <= inlier_threshold * inlier_threshold)
    return (jnp.sum(m * s), jnp.sum(m), jnp.sum(inl * s), jnp.sum(inl))


def evaluate(params: Params, problem: Problem,
             with_jacobians: bool = True) -> Evaluation:
    """Evaluate corrected residuals (and block Jacobians) for all obs.

    Masking applied: observation padding mask on r and J; free-masks
    (constant parameter blocks) zero the corresponding J columns — the
    equivalent of Ceres ``SetParameterBlockConstant`` (SURVEY.md §3.2).
    """
    obs = problem.obs
    gathered = _gather(params, obs)
    f = _gathered_residual_fn(problem)
    ni = problem.intr_tangent_dim
    dtype = params.dtype
    zeros = (jnp.zeros(POSE_DOF, dtype), jnp.zeros(POSE_DOF, dtype),
             jnp.zeros(ni, dtype), jnp.zeros(3, dtype))

    def res_one(qa, ca, qb, cb, intr, X, uv, t):
        return f(*zeros, qa, ca, qb, cb, intr, X, uv, t)

    r = jax.vmap(res_one)(*gathered, obs.uv, obs.t)

    if not with_jacobians:
        s = jnp.sum(r * r, axis=-1)
        rho, _, _ = problem.loss.evaluate(s)
        cost = 0.5 * jnp.sum(obs.mask * rho)
        # corrected residual for RMSE-style reporting
        rt, _, _ = problem.loss.correct(r, None)
        rt = rt * obs.mask[:, None]
        return Evaluation(r=rt, cost=cost, J_pose=None, J_intr=None, J_pt=None)

    def jac_one(qa, ca, qb, cb, intr, X, uv, t):
        return jax.jacfwd(f, argnums=(0, 1, 2, 3))(
            *zeros, qa, ca, qb, cb, intr, X, uv, t)

    J_pa, J_pb, J_intr, J_pt = jax.vmap(jac_one)(*gathered, obs.uv, obs.t)
    # (N,2,6),(N,2,6),(N,2,ni),(N,2,3)

    # Robust (Triggs) correction on the concatenated Jacobian.
    J_full = jnp.concatenate([J_pa, J_pb, J_intr, J_pt], axis=-1)
    rt, Jt, rho = problem.loss.correct(r, J_full)
    cost = 0.5 * jnp.sum(obs.mask * rho)

    # Masks: padding, and constant-block (free) masks.
    m = obs.mask[:, None]
    rt = rt * m
    mJ = obs.mask[:, None, None]
    Jt = Jt * mJ
    J_pa, J_pb, J_intr, J_pt = jnp.split(
        Jt, [POSE_DOF, 2 * POSE_DOF, 2 * POSE_DOF + ni], axis=-1)
    J_pa = J_pa * problem.pose_free[obs.pose_a][:, None, None]
    J_pb = J_pb * problem.pose_free[obs.pose_b][:, None, None]
    if ni > 0:
        J_intr = J_intr * problem.intr_free[obs.intr_idx][:, None, None]
    J_pt = J_pt * problem.point_free[obs.point][:, None, None]

    return Evaluation(r=rt, cost=cost,
                      J_pose=jnp.stack([J_pa, J_pb], axis=2),
                      J_intr=J_intr, J_pt=J_pt)


def apply_tangent(params: Params, problem: Problem, d_pose: jax.Array,
                  d_intr: jax.Array, d_pt: jax.Array) -> Params:
    """Retract a tangent step onto the parameters (free blocks only).

    d_pose: (P, 6), d_intr: (K, ni), d_pt: (M, 3).
    """
    d_pose = d_pose * problem.pose_free[:, None]
    d_pt = d_pt * problem.point_free[:, None]
    q = quat.boxplus(params.q, d_pose[:, :3])
    c = params.c + d_pose[:, 3:]
    if problem.intr_tangent_dim > 0:
        d_intr = d_intr * problem.intr_free[:, None]
        intr = params.intr + d_intr @ problem.intr_basis.T
    else:
        intr = params.intr
    return Params(q=q, c=c, intr=intr, points=params.points + d_pt)
