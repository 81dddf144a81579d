"""Runtime gradient checker — parity with ``ceres::GradientChecker`` /
``Solver::Options::check_gradients`` (SURVEY.md §2 C25).

Verifies the autodiff block Jacobians (residuals.evaluate — our Jet
equivalent) against central finite differences of the same tangent-space
residual function, on a deterministic sample of observations.  Enabled
with ``SolverOptions(check_gradients=True)``: lm.solve runs the check on
the initial parameters and raises on a violation, like Ceres aborting
the solve with a gradient-check report.

The check is evaluator-independent (it exercises the flat oracle path);
the engine equivalence tests in tests/ extend the guarantee to the
window evaluator.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..problem.types import POSE_DOF, Params, Problem
from . import residuals


def check_gradients(problem: Problem, params: Params,
                    relative_precision: float = 1e-5,
                    max_samples: int = 64,
                    step: float | None = None) -> dict:
    """Compare autodiff vs central-FD Jacobians on sampled observations.

    Returns a report dict {"max_relative_error", "n_checked",
    "worst_obs"}; raises ValueError when the worst relative error (with
    an absolute floor scaled to the Jacobian's magnitude) exceeds
    ``relative_precision``.

    FD runs in the problem dtype; with f32 the practical floor is ~1e-3
    — pass a matching ``relative_precision``.  ``step`` defaults to
    eps**(1/3) (central-difference optimum).
    """
    obs = problem.obs
    mask = np.asarray(obs.mask) > 0
    valid = np.nonzero(mask)[0]
    if valid.size == 0:
        return {"max_relative_error": 0.0, "n_checked": 0, "worst_obs": -1}
    rng = np.random.RandomState(0)
    sel = np.sort(rng.choice(valid, size=min(max_samples, valid.size),
                             replace=False))
    sub = jax.tree.map(lambda a: a[sel], obs)
    sub_problem = problem.replace(obs=sub)

    dtype = params.dtype
    eps = jnp.finfo(dtype).eps
    h = float(eps) ** (1.0 / 3.0) if step is None else step

    # Autodiff (uncorrected: compare pure Jacobians, so use a trivial-loss
    # view — the Triggs correction is a separately-tested transformation).
    from ..geometry import Loss
    plain = Problem(obs=sub, pose_free=problem.pose_free,
                    point_free=problem.point_free,
                    intr_free=problem.intr_free,
                    intr_basis=problem.intr_basis,
                    model=problem.model, loss=Loss())
    ev = residuals.evaluate(params, plain, with_jacobians=True)
    ni = plain.intr_tangent_dim
    J_ad = np.concatenate(
        [np.asarray(ev.J_pose[:, :, 0, :]), np.asarray(ev.J_pose[:, :, 1, :]),
         np.asarray(ev.J_intr), np.asarray(ev.J_pt)], axis=-1)  # (n,2,15+ni)

    f = residuals._gathered_residual_fn(plain)
    gathered = residuals._gather(params, sub)

    def res_at(d, qa, ca, qb, cb, intr, X, uv, t):
        d_pa = d[:POSE_DOF]
        d_pb = d[POSE_DOF:2 * POSE_DOF]
        d_i = d[2 * POSE_DOF:2 * POSE_DOF + ni]
        d_pt = d[2 * POSE_DOF + ni:]
        return f(d_pa, d_pb, d_i, d_pt, qa, ca, qb, cb, intr, X, uv, t)

    dim = 2 * POSE_DOF + ni + 3

    def fd_one(qa, ca, qb, cb, intr, X, uv, t):
        eye = jnp.eye(dim, dtype=dtype) * h
        plus = jax.vmap(lambda d: res_at(d, qa, ca, qb, cb, intr, X, uv,
                                         t))(eye)
        minus = jax.vmap(lambda d: res_at(-d, qa, ca, qb, cb, intr, X, uv,
                                          t))(eye)
        return ((plus - minus) / (2.0 * h)).T        # (2, dim)

    J_fd = np.asarray(jax.vmap(fd_one)(*gathered, sub.uv, sub.t))
    # Constant-block masks (autodiff J has them applied).
    col_mask = np.concatenate([
        np.repeat(np.asarray(problem.pose_free)[np.asarray(sub.pose_a)][:,
                                                None], 6, axis=1),
        np.repeat(np.asarray(problem.pose_free)[np.asarray(sub.pose_b)][:,
                                                None], 6, axis=1),
        (np.repeat(np.asarray(problem.intr_free)[np.asarray(sub.intr_idx)][
            :, None], ni, axis=1) if ni else np.zeros((sel.size, 0))),
        np.repeat(np.asarray(problem.point_free)[np.asarray(sub.point)][:,
                                                 None], 3, axis=1)], axis=1)
    J_fd = J_fd * col_mask[:, None, :]

    scale = np.maximum(np.abs(J_ad), np.abs(J_fd))
    floor = max(1e-3 * scale.max(), 1e-12)
    rel = np.abs(J_ad - J_fd) / np.maximum(scale, floor)
    worst = int(np.argmax(rel.max(axis=(1, 2))))
    report = {"max_relative_error": float(rel.max()),
              "n_checked": int(sel.size), "worst_obs": int(sel[worst])}
    if report["max_relative_error"] > relative_precision:
        raise ValueError(
            f"gradient check FAILED: max relative error "
            f"{report['max_relative_error']:.3e} > {relative_precision:g} "
            f"at observation {report['worst_obs']} "
            f"(autodiff vs central FD, h={h:.2e}, "
            f"{report['n_checked']} observations sampled)")
    return report
