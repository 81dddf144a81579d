"""Covariance estimation — parity with ``ceres::Covariance`` (SURVEY.md
§2 C27).

Computes Gauss-Newton parameter covariances at the solution from the
robust-corrected Jacobian, exploiting the same Schur structure the
solver uses:

    H = [B  E; Eᵀ C]   (camera / point blocks, no damping)
    cov(cameras) = S⁻¹            with S = B − E C⁻¹ Eᵀ
    cov(point m) = C_m⁻¹ + C_m⁻¹ E_mᵀ S⁻¹ E_m C_m⁻¹

so the only dense inverse is of the reduced camera system S (Dc × Dc),
never of the full H — points are recovered per-point in closed form,
exactly like the solver's back-substitution.  Ceres computes the same
quantities via sparse factorization of JᵀJ; the batched dense-S form is
the batched equivalent and is exact.

Gauge handling: constant blocks (pose_free/point_free masks — e.g. the
gauge-fixed first camera) have identically zero Jacobian columns, which
would make S singular.  Their tangent diagonal is pinned to 1 for the
inverse and their covariance zeroed afterwards — they are not random
variables.  Covariance is only defined on a FULLY gauge-fixed problem:
a free similarity gauge (7 dof — rotation, translation, scale) makes H
genuinely singular.  Fixing one pose removes 6 dof; pin at least one
more (a second pose, or one point) before calling, otherwise the
Cholesky of S produces NaNs.

Scaling: cov(x) assumes unit-variance residuals (Ceres convention).
Multiply by ``sigma2_estimate`` (2·cost / (n_residuals − n_params)) for
the data-driven scale.  Dense S limits this to Dc ≲ 15k (≈2.5k poses);
beyond that, pose covariance of a 10k-pose video is dominated by drift
and better answered per-window — raise ``max_cam_dim`` explicitly if you
really want the big inverse.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..problem.types import POSE_DOF, Params, Problem
from . import assembly, residuals
from .schur import assemble_B_dense, assemble_E_dense, invert_3x3_psd


@dataclasses.dataclass
class CovarianceResult:
    pose: jax.Array          # (P, 6, 6) per-pose tangent covariance
    point: jax.Array         # (M, 3, 3) per-point covariance
    cam_full: jax.Array      # (Dc, Dc) full camera-block covariance S⁻¹
    sigma2_estimate: float   # 2·cost / (n_res − n_params)


def compute_covariance(problem: Problem, params: Params,
                       max_cam_dim: int = 15000,
                       point_jitter: float = 0.0) -> CovarianceResult:
    """Gauss-Newton covariance at ``params`` (normally the solution).

    ``point_jitter`` adds εI to the point blocks before inversion for
    problems with weakly-observed landmarks (2-view shallow-angle
    tracks); 0 keeps the estimate exact.
    """
    shapes = assembly.tangent_shapes(problem, params)
    Dc = shapes.cam_dim
    if Dc > max_cam_dim:
        raise ValueError(
            f"camera tangent dim {Dc} exceeds max_cam_dim={max_cam_dim}; "
            "dense S⁻¹ would need "
            f"{Dc * Dc * 8 / 2**30:.1f} GiB — raise max_cam_dim to force")
    ev = residuals.evaluate(params, problem, with_jacobians=True)

    B = assemble_B_dense(ev, problem, shapes)
    A = assemble_E_dense(ev, problem, shapes)         # (M, 3, Dc) = Eᵀ rows
    C = assembly.point_hessian_blocks(ev, problem, shapes)

    # Pin constant/unobserved tangent dims to identity for the inverses.
    pose_free6 = jnp.repeat(problem.pose_free, POSE_DOF)
    if shapes.ni > 0:
        cam_free = jnp.concatenate(
            [pose_free6, jnp.repeat(problem.intr_free, shapes.ni)])
    else:
        cam_free = pose_free6
    B = B + jnp.diag(jnp.where(cam_free > 0, 0.0, 1.0))
    # A free point with fewer than two (valid) observations has a
    # rank-deficient 3×3 information block (a single 2-D observation
    # cannot constrain depth) — covariance undefined; pin it like a
    # constant block and zero it out.  Ceres's Covariance likewise fails
    # on rank-deficient JᵀJ unless the user opts into SVD handling.
    n_obs_per_pt = jax.ops.segment_sum(
        problem.obs.mask, problem.obs.point,
        num_segments=shapes.n_points)
    observed = n_obs_per_pt >= 2
    pt_free = problem.point_free * observed.astype(problem.point_free.dtype)
    eye3 = jnp.eye(3, dtype=C.dtype)
    # Pinning = conditioning on the pinned blocks: zero their coupling
    # and information, identity on their diagonal (the free-submatrix
    # inverse then equals the full inverse restricted to free dims).
    A = A * pt_free[:, None, None]
    C = (C * pt_free[:, None, None]
         + jnp.where(pt_free > 0, point_jitter, 1.0)[:, None, None] * eye3)

    C_inv = invert_3x3_psd(C)
    Y = jnp.einsum("mab,mbd->mad", C_inv, A)          # C⁻¹Eᵀ  (M, 3, Dc)
    S = B - jnp.einsum("mad,mae->de", A, Y)

    # S⁻¹ via Cholesky (S is PD after gauge pinning).
    L = jnp.linalg.cholesky(S)
    Si = jax.scipy.linalg.cho_solve((L, True), jnp.eye(Dc, dtype=S.dtype))

    # Per-point covariance: C⁻¹ + (C⁻¹Eᵀ) S⁻¹ (C⁻¹Eᵀ)ᵀ.
    pt_cov = C_inv + jnp.einsum("mad,de,mbe->mab", Y, Si, Y)

    # Zero out constant blocks (they are not random variables).
    cam_mask = cam_free[:, None] * cam_free[None, :]
    Si = Si * cam_mask
    pt_cov = pt_cov * pt_free[:, None, None]

    P = shapes.n_poses
    pose_cov = Si[:P * POSE_DOF, :P * POSE_DOF].reshape(
        P, POSE_DOF, P, POSE_DOF)[jnp.arange(P), :, jnp.arange(P), :]

    n_res = float(2.0 * jnp.sum(problem.obs.mask))
    n_par = float(jnp.sum(cam_free) + 3.0 * jnp.sum(pt_free))
    cost = float(residuals.cost_only(params, problem))
    sigma2 = 2.0 * cost / max(n_res - n_par, 1.0)
    return CovarianceResult(pose=pose_cov, point=pt_cov, cam_full=Si,
                            sigma2_estimate=sigma2)
