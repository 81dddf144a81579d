"""Traditional Dogleg trust-region strategy.

Parity: Ceres ``DoglegStrategy`` (TRADITIONAL_DOGLEG; SURVEY.md §2 C17
"(+ Dogleg)").  Like Ceres, dogleg requires an EXACT step solver — the
Gauss-Newton point must be a real minimizer for the dogleg path to make
sense — so it composes with ``dense`` and ``dense_schur`` only
(``iterative_schur``'s inexact CG step would break the geometry; Ceres
imposes the same restriction).

Accelerator shape: the expensive work (one factorization + Gauss-Newton
solve, one Hessian-gradient product) happens ONCE per Jacobian inside
``prepare`` — each trust-region retry is a closed-form blend of the
cached Cauchy and Gauss-Newton points (a few vector ops), so radius
backtracking costs microseconds instead of a new linear solve (the
whole point of dogleg over LM).

Space convention: the dogleg geometry runs in the UNSCALED tangent
space.  (Ceres blends in the Jacobi-scaled space; the scaling still
conditions the inner linear solves here, but the trust region itself is
isotropic in the raw tangent coordinates — documented divergence, same
fixed points.)

The piecewise path for trust radius Δ:
  ‖dx_gn‖ ≤ Δ                → dx_gn                      (full GN step)
  ‖dx_sd‖ ≥ Δ                → Δ·dx_sd/‖dx_sd‖            (scaled Cauchy)
  else                        → dx_sd + β(dx_gn − dx_sd),  ‖dx‖ = Δ
with dx_sd = −(‖g‖²/‖Jg‖²)·g the Cauchy point.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..problem.types import Params, Problem
from . import assembly
from .options import SolverOptions

#: trust-region radius used to extract the near-undamped Gauss-Newton
#: step from the base LM solver: λ = clamp(diag)/1e8.  Not ∞ — free-gauge
#: BA Hessians carry an exact scale null direction (cost-invariant), and
#: a truly undamped Cholesky factorizes a singular matrix into NaNs; the
#: 1e-8-relative damping regularizes only the null space (Ceres's
#: DoglegStrategy likewise retries its GN solve with increasing μ on
#: factorization failure).
_GN_RADIUS = 1e8


def _flat_parts(problem: Problem):
    shapes = assembly.TangentShapes(
        problem.pose_free.shape[0], problem.intr_free.shape[0],
        problem.intr_tangent_dim, problem.point_free.shape[0])
    return shapes


def make_dogleg_solver(problem: Problem, options: SolverOptions):
    """(prepare, solve_step) for the LM driver, dogleg strategy.

    Wraps the exact-step base engine named by ``options.linear_solver``;
    ``solve_step(aux, radius)`` returns (dx, predicted_decrease, 0) like
    every other engine, so the trust-region driver is unchanged apart
    from its radius-update rule (see lm.solve).
    """
    base = options.linear_solver
    materialized_dense = False
    if base == "dense":
        from .dense import (make_dense_solver,
                            _DENSE_MATERIALIZE_MAX_ELEMS)
        prepare_b, solve_b = make_dense_solver(problem, options)
        shapes0 = _flat_parts(problem)
        n_obs = int(problem.obs.uv.shape[0])
        # make_dense_solver delegates large problems to point-block
        # elimination (same exact step, schur-shaped aux) — use the
        # matching closures below in that case.
        materialized_dense = (2 * n_obs * shapes0.total_dim
                              <= _DENSE_MATERIALIZE_MAX_ELEMS)
    if materialized_dense:

        def gradient(aux):
            return aux["g"]

        def h_apply(aux, dx):
            return aux["H"] @ dx

    elif base in ("dense", "dense_schur"):
        from .schur import (camera_entries, gn_hessian_apply,
                            make_dense_schur_solver)
        if base == "dense_schur":
            prepare_b, solve_b = make_dense_schur_solver(problem, options)
        shapes = _flat_parts(problem)

        def gradient(aux):
            # aux carries the SCALED gradient g̃ = D·g; unscale.
            # (s_pt is stored flat (M·3,) — reshape to the block form.)
            g_cam = aux["g_cam"] / aux["s_cam"]
            g_pt = aux["g_pt"] / aux["s_pt"].reshape(-1, 3)
            return jnp.concatenate([g_cam, g_pt.reshape(-1)])

        def h_apply(aux, dx):
            # H = D⁻¹ H̃ D⁻¹ with H̃ the scaled GN Hessian in aux["ev"]
            # (applied through the factory's layout-matched closure).
            s_cam = aux["s_cam"]
            s_pt = aux["s_pt"].reshape(-1, 3)
            Dc = s_cam.shape[0]
            u_cam = dx[:Dc] / s_cam
            u_pt = dx[Dc:].reshape(-1, 3) / s_pt
            hc, hp = prepare_b.hessian_apply(aux["ev"], u_cam, u_pt)
            return jnp.concatenate([hc / s_cam, (hp / s_pt).reshape(-1)])

    else:
        raise ValueError(
            "trust_region_strategy='dogleg' requires an exact step solver "
            f"(linear_solver 'dense' or 'dense_schur'), got {base!r} — "
            "the same restriction Ceres's DoglegStrategy imposes")

    def prepare(params: Params):
        aux = prepare_b(params)
        dx_gn, _, _ = solve_b(aux, jnp.asarray(_GN_RADIUS,
                                               aux["cost"].dtype))
        g = gradient(aux)
        Hg = h_apply(aux, g)
        aux["dx_gn"] = dx_gn
        aux["g_flat"] = g
        aux["gg"] = jnp.dot(g, g)
        aux["gHg"] = jnp.dot(g, Hg)
        return aux

    def solve_step(aux, radius):
        dx_gn = aux["dx_gn"]
        g = aux["g_flat"]
        gg, gHg = aux["gg"], aux["gHg"]
        dtype = g.dtype
        radius = jnp.asarray(radius, dtype)

        alpha = jnp.where(gHg > 0, gg / jnp.maximum(gHg, 1e-30), 0.0)
        dx_sd = -alpha * g
        n_sd = alpha * jnp.sqrt(gg)
        # A non-finite GN solve (factorization breakdown) degrades to the
        # Cauchy segment: n_gn = ∞ keeps the GN branch unselected.
        gn_ok = jnp.all(jnp.isfinite(dx_gn))
        n_gn = jnp.where(gn_ok, jnp.linalg.norm(
            jnp.where(jnp.isfinite(dx_gn), dx_gn, 0.0)), jnp.inf)
        dx_gn = jnp.where(gn_ok, jnp.where(jnp.isfinite(dx_gn), dx_gn,
                                           0.0), dx_sd)

        # Blend coefficient β solving ‖dx_sd + β(dx_gn − dx_sd)‖ = Δ.
        v = dx_gn - dx_sd
        vv = jnp.dot(v, v)
        sv = jnp.dot(dx_sd, v)
        disc = jnp.maximum(sv * sv + vv * (radius ** 2 - n_sd ** 2), 0.0)
        beta = jnp.where(vv > 0,
                         (-sv + jnp.sqrt(disc)) / jnp.maximum(vv, 1e-30),
                         0.0)
        blend = dx_sd + jnp.clip(beta, 0.0, 1.0) * v

        cauchy = dx_sd * (radius / jnp.maximum(n_sd, 1e-30))
        dx = jnp.where(n_gn <= radius, dx_gn,
                       jnp.where(n_sd >= radius, cauchy, blend))

        Hdx = h_apply(aux, dx)
        predicted = -(jnp.dot(g, dx) + 0.5 * jnp.dot(dx, Hdx))
        return dx, predicted, jnp.asarray(0, jnp.int32)

    return prepare, solve_step


def update_radius_dogleg(radius: float, rho: float, step_norm: float,
                         accepted: bool, options: SolverOptions) -> float:
    """Ceres DoglegStrategy radius rules (StepAccepted/StepRejected).

    Accepted: poor-but-acceptable steps (ρ < 0.25) halve the radius;
    very good steps (ρ > 0.75) grow it to ≥ 3·‖step‖.  Rejected: halve.
    (No lower clamp — the driver terminates when the radius undershoots
    ``options.min_radius``.)
    """
    if accepted:
        if rho < 0.25:
            radius = 0.5 * radius
        elif rho > 0.75:
            radius = max(radius, 3.0 * step_norm)
    else:
        radius = 0.5 * radius
    return min(radius, options.max_radius)
