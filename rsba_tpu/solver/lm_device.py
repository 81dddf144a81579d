"""On-device Levenberg–Marquardt loop — zero host round-trips per iteration.

Parity: the same trust-region semantics as the host driver (lm.solve /
Ceres ``TrustRegionMinimizer``, SURVEY.md §2 C17), but the whole loop —
prepare (evaluate+assemble), damped Schur solve, retraction, cost
decrease, accept/reject, radius update, convergence tests — runs inside
ONE ``lax.while_loop`` dispatch.  Only scalars and a fixed-size
per-attempt record table are read back when the loop exits.

Why: the host loop pays dispatch and read-back latency for every phase
of every iteration, which small problems cannot hide behind compute
(SURVEY.md §7.2 item 5, BASELINE.json "speed-of-light per iteration").

Loop structure (one ``body`` = one step *attempt*, matching the host
loop's inner retry loop flattened):

* body entry invariant: ``aux`` (the prepare output) is valid for the
  current ``params`` and no termination has fired;
* the attempt runs solve_step → apply_step → cost_decrease; invalid
  steps (non-finite dx or non-positive predicted decrease) shrink the
  radius and force a re-prepare, exactly like the host loop's
  break-to-outer;
* accepted steps update params and re-prepare; rejected valid steps
  reuse ``aux`` (the Jacobian is not re-evaluated — Ceres evaluator
  reuse);
* the re-prepare happens at the *end* of the body under ``lax.cond``, so
  block boundaries (for checkpoint callbacks) can resume mid-rejection
  without consuming an extra outer iteration: the re-entry prepare is
  un-charged (``charge=False``) and re-checks nothing.

Termination codes (read back as one int32):
  1 gradient tolerance   2 non-finite cost        3 invalid-step budget
  4 function tolerance   5 parameter tolerance    6 stagnant rejection
  7 radius below minimum 8 max iterations         0 still running
                                                    (attempt-cap block exit)
"""
from __future__ import annotations

import time
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .options import SolverOptions
from .summary import IterationSummary, Summary

TERM_RUNNING = 0
TERM_GRADIENT = 1
TERM_FAIL_COST = 2
TERM_FAIL_INVALID = 3
TERM_FTOL = 4
TERM_PTOL = 5
TERM_FTOL_STAGNANT = 6
TERM_RADIUS = 7
TERM_MAX_ITERATIONS = 8

_TERMINATIONS = {
    TERM_GRADIENT: ("CONVERGENCE", "gradient tolerance reached"),
    TERM_FAIL_COST: ("FAILURE", "non-finite cost"),
    TERM_FAIL_INVALID: ("FAILURE", "too many consecutive invalid steps"),
    TERM_FTOL: ("CONVERGENCE", "function tolerance reached"),
    TERM_PTOL: ("CONVERGENCE", "parameter tolerance reached"),
    TERM_FTOL_STAGNANT: ("CONVERGENCE",
                         "function tolerance reached (stagnant rejected "
                         "step)"),
    TERM_RADIUS: ("CONVERGENCE", "trust region radius below minimum"),
    TERM_MAX_ITERATIONS: ("NO_CONVERGENCE", "max iterations reached"),
}

#: record columns: cost, cost_change, gmax, step_norm, rho, radius,
#: accepted, linear-solver iterations
N_REC = 8


class _LoopState(NamedTuple):
    params: object       # engine-internal Params pytree
    aux: object          # prepare output pytree
    rho_ref: object      # per-slot XLA robust costs of current params
                         # (engines with "cost_decrease_pair"; else ())
    cost: jax.Array      # current (accepted) cost
    gmax: jax.Array      # gradient max-norm at last prepare
    radius: jax.Array
    df: jax.Array        # decrease factor (rejection backoff)
    inv: jax.Array       # consecutive invalid steps (int32)
    n_outer: jax.Array   # prepares charged so far (int32)
    n_att: jax.Array     # attempts this dispatch (int32)
    n_rec: jax.Array     # records written this dispatch (int32)
    term: jax.Array      # termination code (int32)
    records: jax.Array   # (block_attempts, N_REC)


def _tree_finite(tree) -> jax.Array:
    ok = jnp.array(True)
    for leaf in jax.tree.leaves(tree):
        ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(leaf)))
    return ok


def make_device_runner(raw: dict, options: SolverOptions,
                       block_attempts: int):
    """Build the jitted whole-loop dispatch.

    ``raw`` holds pure phase closures, each taking the engine's ``bound``
    payload (plan/problem pytrees) as first argument so observation-sized
    data stays a runtime input of the executable:

      prepare(bound, params) -> aux           (must contain "cost",
                                               "gradient_max_norm")
      solve_step(bound, aux, radius) -> (dx, predicted, lin_iters)
      apply_step(bound, params, dx) -> (cand, step_norm, x_norm)
      cost_decrease(bound, p_old, p_new) -> scalar

    Returns ``run(bound, params, radius, df, inv, n_outer, charge)`` —
    jitted; ``charge`` (traced bool) marks whether the entry prepare
    consumes an outer iteration (True on the first dispatch, False on
    block re-entries, where it merely recomputes the aux the previous
    dispatch already charged).
    """
    gtol = options.gradient_tolerance
    ftol = options.function_tolerance
    ptol = options.parameter_tolerance
    max_it = options.max_iterations

    def _prep_checks(aux, charge):
        cost = aux["cost"]
        gmax = aux["gradient_max_norm"]
        term = jnp.where(
            jnp.logical_and(charge, ~jnp.isfinite(cost)),
            TERM_FAIL_COST, TERM_RUNNING)
        term = jnp.where(
            (term == TERM_RUNNING) & charge & (gmax <= gtol),
            TERM_GRADIENT, term)
        return cost, gmax, jnp.asarray(term, jnp.int32)

    def body(bound, s: _LoopState) -> _LoopState:
        dtype = s.cost.dtype
        dx, predicted, li = raw["solve_step"](bound, s.aux, s.radius)
        cand, step_norm, x_norm = raw["apply_step"](bound, s.params, dx)
        # Pairwise cost decrease from ONE residual pass on the candidate:
        # ρ_ref (the current params' per-slot costs, same evaluator) is
        # loop-carried — seeded at dispatch entry, replaced by the
        # accepted candidate's ρ_new below.
        if "cost_decrease_pair" in raw:
            decrease, rho_new = raw["cost_decrease_pair"](bound, s.rho_ref,
                                                          cand)
        else:
            decrease = raw["cost_decrease"](bound, s.params, cand)
            rho_new = s.rho_ref

        valid = (_tree_finite(dx) & (predicted > 0)
                 & jnp.isfinite(predicted))
        new_cost = s.cost - decrease
        rho = jnp.where(valid, decrease / predicted, 0.0)
        accept = valid & jnp.isfinite(new_cost) & (
            rho > options.min_relative_decrease)

        # Radius update (Ceres LM rules).
        grow = s.radius / jnp.maximum(
            1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        radius = jnp.where(accept,
                           jnp.minimum(grow, options.max_radius),
                           s.radius / s.df)
        df = jnp.where(accept, 2.0, s.df * 2.0)
        inv = jnp.where(valid, 0, s.inv + 1).astype(jnp.int32)

        params = jax.tree.map(
            lambda a, b: jnp.where(accept, b, a), s.params, cand)
        rho_ref = jax.tree.map(
            lambda a, b: jnp.where(accept, b, a), s.rho_ref, rho_new)
        cost = jnp.where(accept, new_cost, s.cost)

        # Termination (first-set wins; all gated on still-running).
        term = s.term
        term = jnp.where((term == 0) & ~valid
                         & (inv > options.max_invalid_steps),
                         TERM_FAIL_INVALID, term)
        stagnant = (valid & ~accept
                    & (predicted <= ftol * s.cost)
                    & (jnp.abs(s.cost - new_cost) <= ftol * s.cost))
        term = jnp.where((term == 0) & stagnant, TERM_FTOL_STAGNANT, term)
        term = jnp.where((term == 0) & accept
                         & (jnp.abs(s.cost - new_cost) <= ftol * s.cost),
                         TERM_FTOL, term)
        term = jnp.where((term == 0) & accept
                         & (step_norm <= ptol * (x_norm + ptol)),
                         TERM_PTOL, term)
        term = jnp.where((term == 0) & ~accept
                         & (radius < options.min_radius),
                         TERM_RADIUS, term)

        # Record (valid attempts only — host-loop parity).
        rec = jnp.stack([
            jnp.where(accept, new_cost, s.cost).astype(dtype),
            (s.cost - new_cost).astype(dtype),
            s.gmax.astype(dtype), step_norm.astype(dtype),
            rho.astype(dtype), radius.astype(dtype),
            accept.astype(dtype), li.astype(dtype)])
        idx = jnp.minimum(s.n_rec, block_attempts - 1)
        records = s.records.at[idx].set(
            jnp.where(valid, rec, s.records[idx]))
        n_rec = s.n_rec + valid.astype(jnp.int32)

        # End-of-body re-prepare: after an accepted step (new params) or
        # an invalid one (host loop breaks to the outer iteration, which
        # re-prepares and charges).
        need_prep = (accept | ~valid) & (term == TERM_RUNNING)
        exhausted = need_prep & (s.n_outer >= max_it)
        term = jnp.where(exhausted, TERM_MAX_ITERATIONS, term)
        run_prep = need_prep & ~exhausted

        def refresh(_):
            aux2 = raw["prepare"](bound, params)
            c2, g2, t2 = _prep_checks(aux2, jnp.array(True))
            return aux2, c2, g2, t2

        def keep(_):
            return s.aux, cost, s.gmax, jnp.asarray(TERM_RUNNING, jnp.int32)

        aux, cost, gmax, t_prep = jax.lax.cond(run_prep, refresh, keep,
                                               None)
        term = jnp.where(term == TERM_RUNNING, t_prep, term)
        n_outer = s.n_outer + run_prep.astype(jnp.int32)

        return _LoopState(params=params, aux=aux, rho_ref=rho_ref,
                          cost=cost, gmax=gmax,
                          radius=radius, df=df, inv=inv, n_outer=n_outer,
                          n_att=s.n_att + 1, n_rec=n_rec,
                          term=jnp.asarray(term, jnp.int32),
                          records=records)

    def run(bound, params, radius, df, inv, n_outer, charge):
        aux = raw["prepare"](bound, params)
        rho_ref = (raw["rho_slots"](bound, params)
                   if "cost_decrease_pair" in raw else ())
        cost0, gmax, term = _prep_checks(aux, charge)
        dtype = cost0.dtype
        n_outer = (jnp.asarray(n_outer, jnp.int32)
                   + charge.astype(jnp.int32))
        state = _LoopState(
            params=params, aux=aux, rho_ref=rho_ref, cost=cost0, gmax=gmax,
            radius=jnp.asarray(radius, dtype), df=jnp.asarray(df, dtype),
            inv=jnp.asarray(inv, jnp.int32), n_outer=n_outer,
            n_att=jnp.asarray(0, jnp.int32),
            n_rec=jnp.asarray(0, jnp.int32), term=term,
            records=jnp.zeros((block_attempts, N_REC), dtype))
        state = jax.lax.while_loop(
            lambda s: (s.term == TERM_RUNNING) & (s.n_att < block_attempts),
            lambda s: body(bound, s), state)
        return {
            "params": state.params, "cost0": cost0, "cost": state.cost,
            "radius": state.radius, "df": state.df, "inv": state.inv,
            "n_outer": state.n_outer, "n_rec": state.n_rec,
            "term": state.term, "records": state.records,
        }

    jf = jax.jit(run)

    def call(*args):
        with jax.default_matmul_precision(options.matmul_precision):
            return jf(*args)

    return call


def run_blocks(fns: dict, params, options: SolverOptions,
               summary: Summary, callback, to_external) -> object:
    """Drive the device loop to termination; fill ``summary`` in place.

    Dispatches in blocks of attempts so an installed checkpoint/iteration
    ``callback`` still fires (once per block, with the latest accepted
    params) — without a callback the whole solve is ONE dispatch.
    Returns the final engine-internal params.
    """
    raw = fns["raw"]
    bound = raw["bound"]
    # Worst case ~17 rejections drive the radius from max to min; 4× the
    # outer budget bounds any realistic attempt count, and an exit at the
    # cap simply re-dispatches (term stays 0).
    max_attempts = 4 * options.max_iterations
    if callback is not None and options.device_block_iters > 0:
        block_attempts = min(4 * options.device_block_iters, max_attempts)
    else:
        block_attempts = max_attempts
    # Cache the jitted runner on the fns dict so repeated solves with the
    # same engine (e.g. a warm-up solve before a timed one) reuse the
    # compiled loop.
    cache = fns.setdefault("_device_runners", {})
    key = (block_attempts, options)
    runner = cache.get(key)
    if runner is None:
        runner = cache[key] = make_device_runner(raw, options,
                                                 block_attempts)

    radius = jnp.asarray(options.initial_radius, jnp.float32)
    df = jnp.asarray(2.0, jnp.float32)
    inv = jnp.asarray(0, jnp.int32)
    n_outer = jnp.asarray(0, jnp.int32)
    charge = jnp.asarray(True)
    first = True
    while True:
        t0 = time.perf_counter()
        out = runner(bound, params, radius, df, inv, n_outer, charge)
        term, n_rec, records = jax.device_get(
            (out["term"], out["n_rec"], out["records"]))
        block_wall = time.perf_counter() - t0
        if first:
            if not summary.iterations:     # not a resumed history
                summary.initial_cost = float(jax.device_get(out["cost0"]))
            first = False
        params, radius, df, inv, n_outer = (
            out["params"], out["radius"], out["df"], out["inv"],
            out["n_outer"])
        charge = jnp.asarray(False)

        n_rec = int(n_rec)
        # Per-record wall attribution: uniform block shares flatter
        # early-convergence metrics (early iterations do most of the CG
        # work — VERDICT r4 weak #2).  When the caller calibrated a
        # per-attempt cost model (bench.py measures the phases), weight
        # each record by t_fixed + t_cg·cg_iters + t_prepare·accepted
        # and scale so the shares sum to the measured block wall.
        model = fns.get("attempt_wall_model")
        if model and n_rec > 0:
            w = [model["t_fixed"]
                 + model["t_cg_iter"] * float(records[i][7])
                 + model["t_prepare"] * float(records[i][6] >= 0.5)
                 for i in range(n_rec)]
            tot = sum(w)
            shares = ([block_wall * wi / tot for wi in w] if tot > 0
                      else [block_wall / n_rec] * n_rec)
        else:
            shares = [block_wall / max(n_rec, 1)] * max(n_rec, 1)
        cb_params = None
        for i in range(n_rec):
            cost, dcost, gmax, snorm, rho, rad, acc, li = (
                float(v) for v in records[i])
            it = IterationSummary(
                iteration=summary.num_iterations, cost=cost,
                cost_change=dcost, gradient_max_norm=gmax,
                step_norm=snorm, relative_decrease=rho,
                trust_region_radius=rad, accepted=bool(acc >= 0.5),
                linear_solver_iterations=int(li), wall_time=shares[i])
            summary.iterations.append(it)
            if it.accepted:
                summary.num_successful_steps += 1
                # Host-loop parity: the callback fires once per ACCEPTED
                # record (so e.g. checkpoint history is complete); only
                # the params argument is coarser — the block's final
                # params, the device loop's intermediates stayed on chip.
                if callback is not None:
                    if cb_params is None:
                        cb_params = (to_external(params)
                                     if to_external is not None else params)
                    callback(summary.num_iterations, cb_params, it)
            else:
                summary.num_unsuccessful_steps += 1
        if int(term) != TERM_RUNNING:
            summary.termination, summary.message = _TERMINATIONS[int(term)]
            break
    return params
