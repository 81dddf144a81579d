"""Levenberg–Marquardt trust-region driver.

Parity: Ceres ``TrustRegionMinimizer`` + ``LevenbergMarquardtStrategy``
(SURVEY.md §2 C17, §3.1): damping λ = 1/μ, step acceptance by relative
decrease ρ, Ceres's exact radius update rules, and the same convergence
tests (gradient / function / parameter tolerance).

Device mapping (SURVEY.md §3.1): the outer loop runs host-side; each phase
(evaluate+assemble, damped solve, candidate cost) is one jitted on-device
computation.  λ retries re-enter only the damped-solve jit — the Jacobian
is not re-evaluated, matching Ceres's evaluator reuse.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from ..problem.types import Params, Problem
from . import assembly, residuals
from .options import SolverOptions
from .summary import IterationSummary, Summary


def _rmse(sq_px_sum: float, n_valid: float) -> float:
    return float(jnp.sqrt(sq_px_sum / jnp.maximum(n_valid, 1.0)))


def inlier_threshold(problem: Problem) -> float:
    """Inlier gate for RMSE reporting: 3× the robust-loss scale (px); no
    gate (inf) for non-robust problems."""
    if problem.loss.kind == "trivial":
        return float("inf")
    return 3.0 * problem.loss.scale


def attach_try_step(fns: dict, options: SolverOptions) -> dict:
    """Fuse solve_step + apply_step + cost_decrease + finiteness into ONE
    jitted dispatch.

    The LM retry loop otherwise costs 3-4 device round-trips per radius
    attempt, each paying dispatch and read-back latency.  ``lm.solve``
    uses ``fns["try_step"]`` when present and reads back only scalars.
    """
    if "try_step" in fns:
        return fns

    def try_step(params, aux, radius):
        dx, predicted, li = fns["solve_step"](aux, radius)
        cand, step_norm, x_norm = fns["apply_step"](params, dx)
        # Both sides of the pairwise decrease come from the same residual
        # evaluator (the device loop instead carries ρ of the current
        # params to keep one pass per attempt).
        decrease = fns["cost_decrease"](params, cand)
        finite = jnp.array(True)
        for leaf in jax.tree.leaves(dx):
            finite = jnp.logical_and(finite, jnp.all(jnp.isfinite(leaf)))
        return cand, predicted, step_norm, x_norm, decrease, li, finite

    jf = jax.jit(try_step)

    def call(params, aux, radius):
        with jax.default_matmul_precision(options.matmul_precision):
            return jf(params, aux, radius)

    fns["try_step"] = call
    return fns


def make_solver_fns(problem: Problem, options: SolverOptions):
    """Build the jitted phase functions for a given problem structure.

    ``linear_solver="auto"`` picks the banded window solver (banded.py)
    when the problem's track structure admits it and falls back to ``iterative_schur`` on the flat layout otherwise.
    ``"banded_schur"`` requires the window layout and raises if it does
    not apply.

    Every returned dict carries ``fns["engine"] = (linear_solver,
    evaluator)`` — the *resolved* pair, recorded in the Summary so logs
    and benchmarks always show which engine actually ran.
    """
    if options.trust_region_strategy == "dogleg":
        # Dogleg needs an exact step solver (Ceres restriction); the
        # factory validates linear_solver and wraps the base engine.
        from .dogleg import make_dogleg_solver
        prepare, solve_step = make_dogleg_solver(problem, options)
        return _flat_fns(problem, options, prepare, solve_step,
                         engine=(options.linear_solver, "xla-flat-dogleg"))
    if options.linear_solver in ("auto", "banded_schur"):
        from .window import build_window_plan
        plan = build_window_plan(problem)
        if plan is not None:
            from .banded import make_window_solver_fns
            return attach_try_step(
                make_window_solver_fns(problem, plan, options), options)
        if options.linear_solver == "banded_schur":
            raise ValueError(
                "banded_schur requires window/track structure (bounded "
                "pose spans, pose_b ∈ {pose_a, pose_a+1}, single fixed "
                "intrinsics block); use linear_solver='auto' to fall back")
        options = dataclasses.replace(options,
                                      linear_solver="iterative_schur")
    if options.linear_solver == "dense":
        from .dense import make_dense_solver
        prepare, solve_step = make_dense_solver(problem, options)
    elif options.linear_solver == "dense_schur":
        from .schur import make_dense_schur_solver
        prepare, solve_step = make_dense_schur_solver(problem, options)
    elif options.linear_solver == "iterative_schur":
        from .pcg import make_iterative_schur_solver
        prepare, solve_step = make_iterative_schur_solver(problem, options)
    else:
        raise ValueError(options.linear_solver)
    return _flat_fns(problem, options, prepare, solve_step,
                     engine=(options.linear_solver, "xla-flat"))


def _flat_fns(problem: Problem, options: SolverOptions, prepare, solve_step,
              engine):
    """Shared phase-fn dict for flat-layout engines (dense / dense_schur /
    iterative_schur / dogleg): retraction, cost, stats — plus jit wrap.

    Engines built on the column-planes path (solver/flatcols.py) attach
    gather-free cost/decrease/stat closures as ``prepare.extras``; they
    replace the residuals.py forms (same math, no observation gathers)
    and give the device loop a one-pass evaluator-consistent decrease.
    """
    extras = getattr(prepare, "extras", None)

    def apply_step(params: Params, dx: jax.Array):
        shapes = assembly.tangent_shapes(problem, params)
        d_pose, d_intr, d_pt = assembly.unflatten_tangent(dx, shapes)
        new_params = residuals.apply_tangent(params, problem, d_pose, d_intr,
                                             d_pt)
        step_norm = jnp.linalg.norm(dx)
        x_norm = jnp.sqrt(
            jnp.sum(params.c ** 2) + jnp.sum(params.points ** 2)
            + jnp.sum(params.q ** 2) + jnp.sum(params.intr ** 2))
        return new_params, step_norm, x_norm

    def cost_fn(params: Params):
        if extras is not None:
            return extras["cost"](params)
        return residuals.cost_only(params, problem)

    def cost_decrease_fn(p_old: Params, p_new: Params):
        if extras is not None:
            return extras["cost_decrease"](p_old, p_new)
        return residuals.cost_decrease(p_old, p_new, problem)

    def error_stats(params: Params):
        if extras is not None:
            return extras["error_stats"](params, inlier_threshold(problem))
        return residuals.error_stats(params, problem,
                                     inlier_threshold(problem))

    def _wrap(f):
        """jit under the configured matmul precision (active at trace time)."""
        jf = jax.jit(f)

        def call(*args):
            with jax.default_matmul_precision(options.matmul_precision):
                return jf(*args)

        call._jitted = jf       # for utils.roofline (XLA cost analysis)
        call._bound = ()
        call._precision = options.matmul_precision
        return call

    fns = attach_try_step({
        "prepare": _wrap(prepare),
        "solve_step": _wrap(solve_step),
        "apply_step": _wrap(apply_step),
        "cost": _wrap(cost_fn),
        "cost_decrease": _wrap(cost_decrease_fn),
        "error_stats": _wrap(error_stats),
        "engine": engine,
    }, options)
    # Raw phase closures → the on-device LM loop (lm_device.py) applies
    # to the flat engines too.  Dogleg keeps the host loop: its radius
    # rules (dogleg.update_radius_dogleg) differ from the LM rules the
    # device loop implements.
    if options.trust_region_strategy == "lm":
        fns["raw"] = {
            "bound": (),
            "prepare": lambda b, p: prepare(p),
            "solve_step": lambda b, aux, radius: solve_step(aux, radius),
            "apply_step": lambda b, p, dx: apply_step(p, dx),
            "cost_decrease": lambda b, a, c: cost_decrease_fn(a, c),
        }
        if extras is not None:
            fns["raw"]["rho_slots"] = (
                lambda b, p: extras["rho_slots"](p))
            fns["raw"]["cost_decrease_pair"] = (
                lambda b, rho_ref, c: extras["cost_decrease_pair"](rho_ref,
                                                                   c))
    return fns


def solve(problem: Problem, params: Params,
          options: SolverOptions = SolverOptions(),
          callback: Optional[Callable] = None,
          fns: Optional[dict] = None,
          summary: Optional[Summary] = None) -> Tuple[Params, Summary]:
    """Run LM to convergence.  Returns (optimized params, Summary).

    ``callback(iteration, params, iteration_summary)`` is invoked after
    every accepted step — parity with ``ceres::IterationCallback``
    (checkpointing hooks onto this, SURVEY.md §5.4).

    ``fns`` overrides the phase functions — this is how the sharded
    multi-chip solver (dist.make_sharded_solver_fns) reuses this driver:
    trust-region control is identical single-chip and multi-host.

    ``summary`` optionally continues an existing Summary (resume path:
    the checkpointer's restored iteration history flows in here so the
    record stream spans restarts).
    """
    t_start = time.perf_counter()
    if options.check_gradients:
        from .gradient_check import check_gradients as _check
        tol = options.gradient_check_relative_precision or (
            1e-5 if params.dtype == jnp.float64 else 2e-3)
        _check(problem, params, relative_precision=tol)
    if fns is None:
        fns = make_solver_fns(problem, options)
    engine = fns.get("engine", (options.linear_solver, ""))
    if summary is None:
        summary = Summary()
    summary.linear_solver = engine[0]
    summary.evaluator = engine[1]
    shapes = assembly.tangent_shapes(problem, params)
    summary.num_residuals = int(2 * jnp.sum(problem.obs.mask))
    summary.num_parameters_tangent = shapes.total_dim

    # Window-native solvers keep points in a padded internal layout;
    # convert at the solve boundary (and for user-visible callbacks).
    to_external = fns.get("to_external")
    if to_external is not None:
        params = fns["to_internal"](params)

    sq0, n_valid, sq0_in, n_in = fns["error_stats"](params)
    summary.initial_rmse = _rmse(sq0, n_valid)
    summary.initial_rmse_inlier = _rmse(sq0_in, n_in)
    summary.preprocessing_time = time.perf_counter() - t_start

    # On-device loop: one lax.while_loop dispatch for the whole solve
    # (lm_device.py).  Per-phase wall attribution is unavailable there —
    # evaluation_time/linear_solver_time stay 0 and the evaluator tag
    # records "+device_loop".
    if options.device_loop == "on" and "raw" not in fns:
        raise ValueError(
            "device_loop='on' requires an engine exposing raw phase "
            "functions (banded window engines); this engine "
            f"({engine[0]}/{engine[1]}) does not")
    if options.device_loop != "off" and "raw" in fns:
        from . import lm_device
        summary.evaluator = engine[1] + "+device_loop"
        params = lm_device.run_blocks(fns, params, options, summary,
                                      callback, to_external)
        summary.final_cost = float(fns["cost"](params))
        sqf, n_valid, sqf_in, n_in = fns["error_stats"](params)
        summary.final_rmse = _rmse(sqf, n_valid)
        summary.final_rmse_inlier = _rmse(sqf_in, n_in)
        if to_external is not None:
            params = to_external(params)
        summary.total_time = time.perf_counter() - t_start
        return params, summary

    radius = options.initial_radius
    decrease_factor = 2.0
    invalid_steps = 0
    cost = None
    terminated = False

    for iteration in range(options.max_iterations):
        it_t0 = time.perf_counter()
        t0 = time.perf_counter()
        aux = fns["prepare"](params)
        aux["cost"].block_until_ready()
        summary.evaluation_time += time.perf_counter() - t0
        cost = float(aux["cost"])
        gmax = float(aux["gradient_max_norm"])
        if summary.num_iterations == 0:
            summary.initial_cost = cost
        if not jnp.isfinite(cost):
            summary.termination = "FAILURE"
            summary.message = "non-finite cost"
            terminated = True
            break
        if gmax <= options.gradient_tolerance:
            summary.termination = "CONVERGENCE"
            summary.message = (f"gradient tolerance reached: "
                               f"{gmax:.3e} <= {options.gradient_tolerance}")
            terminated = True
            break

        accepted = False
        new_params = params
        rho = 0.0
        step_norm = 0.0
        new_cost = cost
        lin_iters = 0
        while not accepted and radius >= options.min_radius:
            t0 = time.perf_counter()
            r_arr = jnp.asarray(radius, dtype=aux["cost"].dtype)
            if "try_step" in fns:
                # Fused single-dispatch attempt (solve + retract + cost
                # decrease + finiteness); one scalar read-back.  NOTE:
                # linear_solver_time then covers the whole attempt, not
                # just the Schur solve.
                (cand, predicted, snorm, xnorm, dec_arr, li,
                 finite) = fns["try_step"](params, aux, r_arr)
                pred_v, step_norm, x_norm, dec_v, li_v, fin_v = (
                    jax.device_get((predicted, snorm, xnorm, dec_arr, li,
                                    finite)))
                summary.linear_solver_time += time.perf_counter() - t0
                pred = float(pred_v)
                step_norm = float(step_norm)
                x_norm = jnp.asarray(x_norm)
                lin_iters = int(li_v)
                dx_finite = bool(fin_v)
                decrease_known = float(dec_v)
            else:
                dx, predicted, li = fns["solve_step"](aux, r_arr)
                jax.block_until_ready(dx)
                summary.linear_solver_time += time.perf_counter() - t0
                lin_iters = int(li)
                cand, snorm, x_norm = fns["apply_step"](params, dx)
                pred = float(predicted)
                step_norm = float(snorm)
                dx_finite = all(
                    bool(jnp.all(jnp.isfinite(leaf)))
                    for leaf in jax.tree.leaves(dx))
                decrease_known = None
            if not (dx_finite and pred > 0 and jnp.isfinite(pred)):
                # Invalid step: shrink and retry (Ceres counts these).
                invalid_steps += 1
                radius /= decrease_factor
                decrease_factor *= 2.0
                if invalid_steps > options.max_invalid_steps:
                    summary.termination = "FAILURE"
                    summary.message = "too many consecutive invalid steps"
                    terminated = True
                break
            invalid_steps = 0
            # Pairwise-differenced decrease (f32-safe); new_cost derived
            # from it for reporting and the ftol tests.
            decrease = (decrease_known if decrease_known is not None
                        else float(fns["cost_decrease"](params, cand)))
            new_cost = cost - decrease
            rho = decrease / pred
            dogleg_rule = options.trust_region_strategy == "dogleg"
            if jnp.isfinite(new_cost) and rho > options.min_relative_decrease:
                accepted = True
                new_params = cand
                if dogleg_rule:
                    from .dogleg import update_radius_dogleg
                    radius = update_radius_dogleg(radius, rho, step_norm,
                                                  True, options)
                else:
                    # Ceres radius growth: μ ← μ / max(1/3, 1 − (2ρ−1)³)
                    radius = min(
                        radius / max(1.0 / 3.0,
                                     1.0 - (2.0 * rho - 1.0) ** 3),
                        options.max_radius)
                decrease_factor = 2.0
            else:
                if dogleg_rule:
                    from .dogleg import update_radius_dogleg
                    radius = update_radius_dogleg(radius, rho, step_norm,
                                                  False, options)
                else:
                    radius /= decrease_factor
                    decrease_factor *= 2.0
                # Stagnation: both the model's predicted decrease and the
                # actual change are below function tolerance — the optimum
                # is resolved to working precision (matters in f32,
                # where Ceres's accepted-step-only ftol test would instead
                # spiral the radius to min over many rejected solves).
                if (pred <= options.function_tolerance * cost
                        and abs(cost - new_cost)
                        <= options.function_tolerance * cost):
                    summary.termination = "CONVERGENCE"
                    summary.message = ("function tolerance reached "
                                       "(stagnant rejected step)")
                    terminated = True

            it = IterationSummary(
                iteration=summary.num_iterations, cost=new_cost if accepted
                else cost, cost_change=cost - new_cost,
                gradient_max_norm=gmax, step_norm=step_norm,
                relative_decrease=float(rho), trust_region_radius=radius,
                accepted=accepted, linear_solver_iterations=lin_iters,
                wall_time=time.perf_counter() - it_t0)
            summary.iterations.append(it)
            if accepted:
                summary.num_successful_steps += 1
            else:
                summary.num_unsuccessful_steps += 1
            if options.verbose:
                print(f"  iter {it.iteration:3d} cost {it.cost:.6e} "
                      f"|g| {gmax:.3e} step {step_norm:.3e} "
                      f"rho {rho:+.3f} radius {radius:.2e} "
                      f"{'ACCEPT' if accepted else 'reject'}")

            if accepted:
                params = new_params
                if callback is not None:
                    cb_params = (to_external(params) if to_external is not None
                                 else params)
                    callback(summary.num_iterations, cb_params, it)
                # Convergence tests (Ceres ordering: after accepted step).
                cost_change = cost - new_cost
                if abs(cost_change) <= options.function_tolerance * cost:
                    summary.termination = "CONVERGENCE"
                    summary.message = (
                        f"function tolerance reached: |Δcost|/cost = "
                        f"{abs(cost_change)/max(cost,1e-30):.3e}")
                    terminated = True
                elif step_norm <= options.parameter_tolerance * (
                        float(x_norm) + options.parameter_tolerance):
                    summary.termination = "CONVERGENCE"
                    summary.message = "parameter tolerance reached"
                    terminated = True
            if terminated:
                break

        if radius < options.min_radius and not accepted:
            summary.termination = "CONVERGENCE"
            summary.message = "trust region radius below minimum"
            terminated = True
        if terminated:
            break

    if not terminated:
        summary.termination = "NO_CONVERGENCE"
        summary.message = f"max iterations ({options.max_iterations}) reached"

    summary.final_cost = float(fns["cost"](params))
    sqf, n_valid, sqf_in, n_in = fns["error_stats"](params)
    summary.final_rmse = _rmse(sqf, n_valid)
    summary.final_rmse_inlier = _rmse(sqf_in, n_in)
    if to_external is not None:
        params = to_external(params)
    summary.total_time = time.perf_counter() - t_start
    return params, summary
