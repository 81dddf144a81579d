"""Sharded banded window solver — the multi-device hot path (config 5).

Extends the banded Schur solver (solver/banded.py) across a device mesh
by sharding the window grid's **row axis** (NR): each shard owns a
contiguous block of window rows — i.e. a contiguous slice of the
trajectory's feature tracks — together with those rows' points and
observation slots.  Poses are replicated (10k poses × 13 floats is
nothing next to 8M observations).

Communication design (SURVEY.md §2.9 P2/P3, BASELINE.json:11):

* ``prepare``: each shard evaluates + assembles its rows; the per-pose
  quantities — g_cam (P, 6) and the B band (P, W, 36) — are partial
  folds psum'd once.  Point-side quantities (g_pt, C, F) stay local.
* ``solve_step``: the Schur band S = B_λ − Σ_shards fold(F C_λ⁻¹ Fᵀ) is
  one psum of a (P, W, 6, 6) band (W·36·P floats ≈ 16 MB at 10k poses);
  the rhs fold is a second, (P, 6)-sized psum.  **PCG then runs fully
  replicated on the materialized band — zero collectives per CG
  iteration** (compare the flat sharded solver, one (Dc,) psum per
  matvec).  Landmark back-substitution is shard-local.
* Trust-region control stays in the host LM driver, identical to the
  single-chip path (replicated decisions from psum'd scalars).

The per-shard evaluator is the XLA window engine (banded.evaluate), the
same one a single device runs.

Reference parity: the reference (single-process Ceres, SURVEY.md §1.2)
has no distributed layer; this module is the multi-device scaling design
BASELINE.json's north star mandates.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..problem.types import POSE_DOF, Params, Problem
from ..solver import banded
from ..solver.options import SolverOptions
from ..solver.pcg import pcg
from ..solver.schur import _lm_scaled_damp, invert_3x3_psd
from ..solver.window import WindowPlan, build_window_plan
from . import mesh as mesh_mod


def _plan_specs(plan: WindowPlan, axis: str) -> WindowPlan:
    """PartitionSpec pytree for a WindowPlan sharded along the row axis."""
    return WindowPlan(
        NR=plan.NR, G=plan.G, L=plan.L, W=plan.W,
        n_poses=plan.n_poses, n_points=plan.n_points,
        row_base=P(axis), uv=P(axis), t=P(axis), mask=P(axis),
        offs_a=P(axis), rs_ab=P(axis), point_id=P(axis),
        point_mask=P(axis))


def _slim(problem: Problem) -> Problem:
    """Problem with observation arrays dropped to one padded row.

    The banded engine reads only model/loss/pose_free/point_free from the
    Problem; replicating the full observation arrays onto every device
    would waste HBM at config-5 scale (the window plan already carries the
    observations, sharded)."""
    obs = problem.obs
    return problem.replace(obs=jax.tree.map(lambda a: a[:1], obs))


def make_sharded_window_solver_fns(problem: Problem, options: SolverOptions,
                                   mesh: Mesh, axis: str = mesh_mod.AXIS,
                                   plan: WindowPlan | None = None):
    """lm.solve-compatible phase fns: banded solver over a sharded plan.

    Builds (or takes) a WindowPlan whose row count is padded to a multiple
    of the mesh size, shards its arrays along NR, and returns the phase
    dict.  Raises ValueError when the problem does not admit the window
    layout — callers fall back to dist.make_sharded_solver_fns (flat).
    """
    n_shards = int(mesh.devices.size)
    if plan is None:
        nr_mult = int(np.lcm(8, n_shards))
        plan = build_window_plan(problem, nr_multiple=nr_mult)
    if plan is None:
        raise ValueError(
            "problem does not admit the window layout; use the flat "
            "sharded solver (dist.make_sharded_solver_fns)")
    if plan.NR % n_shards:
        raise ValueError(f"plan rows ({plan.NR}) not divisible by mesh "
                         f"size ({n_shards}); rebuild with nr_multiple="
                         f"lcm(8, {n_shards})")
    nr_local = plan.NR // n_shards
    P_poses = plan.n_poses
    prob_slim = _slim(problem)

    plan_sharded = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        plan, _plan_specs(plan, axis))
    prob_spec = jax.tree.map(lambda _: P(), prob_slim)
    par_spec_int = Params(q=P(), c=P(), intr=P(), points=P(axis))
    plan_spec = _plan_specs(plan, axis)

    from ..solver.lm import inlier_threshold
    thresh = inlier_threshold(problem)

    def _local(plan_blk: WindowPlan) -> WindowPlan:
        # Inside shard_map the arrays are the local row block; fix the
        # static row count so reshapes see the local geometry.
        return plan_blk.replace(NR=nr_local)

    def _psum(x):
        return jax.lax.psum(x, axis)

    # --- prepare ------------------------------------------------------------

    def prepare_blk(plan_blk, problem_blk, params_blk):
        plan_l = _local(plan_blk)
        ev = banded.evaluate(params_blk, plan_l, problem_blk)
        a = banded.assemble(ev, plan_l)
        cost = _psum(ev.cost)
        g_cam = _psum(a.g_cam)                       # (P, 6)
        B_band = _psum(a.B_band)                     # (P, W, 6, 6)
        a = banded.BandAssembly(g_cam=g_cam, g_pt=a.g_pt, C=a.C, F=a.F,
                                B_band=B_band)

        d_cam = jnp.diagonal(B_band[:, 0], axis1=-2, axis2=-1)
        d_pt = jnp.diagonal(a.C, axis1=-2, axis2=-1)
        gmax = jnp.maximum(jnp.max(jnp.abs(g_cam)),
                           jax.lax.pmax(jnp.max(jnp.abs(a.g_pt)), axis))
        if options.jacobi_scaling:
            s_cam = jnp.where(
                d_cam > 0, 1.0 / (1.0 + jnp.sqrt(jnp.maximum(d_cam, 0.0))),
                1.0)
            s_pt = jnp.where(
                d_pt > 0, 1.0 / (1.0 + jnp.sqrt(jnp.maximum(d_pt, 0.0))),
                1.0)
            # scale_assembly is shard-safe: B_band/g_cam are global
            # (replicated) and point-side arrays local; s_cam is global.
            a = banded.scale_assembly(a, plan_l, s_cam, s_pt)
        else:
            s_cam = jnp.ones_like(d_cam)
            s_pt = jnp.ones_like(d_pt)
        return {"cost": cost, "a": a, "s_cam": s_cam, "s_pt": s_pt,
                "gradient_max_norm": gmax}

    def aux_specs():
        a = banded.BandAssembly(g_cam=P(), g_pt=P(axis), C=P(axis),
                                F=P(axis), B_band=P())
        return {"cost": P(), "a": a, "s_cam": P(), "s_pt": P(axis),
                "gradient_max_norm": P()}

    # --- solve_step ---------------------------------------------------------

    def solve_step_blk(plan_blk, aux, radius):
        plan_l = _local(plan_blk)
        a: banded.BandAssembly = aux["a"]

        d_cam = jnp.diagonal(a.B_band[:, 0], axis1=-2, axis2=-1)
        lm_cam, _ = _lm_scaled_damp(d_cam.reshape(-1), radius, options)
        lm_cam = lm_cam.reshape(P_poses, POSE_DOF)
        c_diag = jnp.diagonal(a.C, axis1=-2, axis2=-1)
        lm_pt, _ = _lm_scaled_damp(c_diag.reshape(-1), radius, options)
        lm_pt = lm_pt.reshape(nr_local, plan.G, 3)
        C_l = a.C + jax.vmap(jax.vmap(jnp.diag))(lm_pt)
        C_inv = invert_3x3_psd(C_l)

        # ONE band-sized psum per outer iteration; CG below is collective-
        # free (replicated on the psum'd band).
        S = a.B_band - _psum(banded.fcf_band(a.F, plan_l, C_inv))
        S = S.at[:, 0].add(jax.vmap(jnp.diag)(lm_cam))

        y0 = jnp.einsum("sgxy,sgy->sgx", C_inv, -a.g_pt)
        b = -a.g_cam - _psum(banded.e_apply(a.F, plan_l, y0))

        precond = banded.make_band_preconditioner(S, options.preconditioner)

        def matvec(p_flat):
            return banded.band_matvec(
                S, p_flat.reshape(P_poses, POSE_DOF)).reshape(-1)

        dc_flat, r_cg, iters = pcg(matvec, precond, b.reshape(-1),
                                   options.max_cg_iterations, options.cg_eta)
        dc = dc_flat.reshape(P_poses, POSE_DOF)

        # Back-substitute landmarks (shard-local).
        w = -a.g_pt - banded.et_apply(a.F, plan_l, dc)
        dp = jnp.einsum("sgxy,sgy->sgx", C_inv, w)

        gTdx = jnp.sum(a.g_cam * dc) + _psum(jnp.sum(a.g_pt * dp))
        dDd = (jnp.sum(lm_cam * dc * dc) + _psum(jnp.sum(lm_pt * dp * dp)))
        predicted = 0.5 * (dDd - gTdx) - 0.5 * jnp.dot(r_cg, dc_flat)

        dx = {"pose": aux["s_cam"] * dc, "pt": aux["s_pt"] * dp}
        return dx, predicted, iters

    step_spec = {"pose": P(), "pt": P(axis)}

    # --- apply / cost / stats -------------------------------------------------

    def _apply_step_blk(plan_blk, problem_blk, params_blk, dx):
        plan_l = _local(plan_blk)
        from ..geometry import quaternion as quat
        point_free_w = plan_l.gather_point_scalar(
            problem_blk.point_free).reshape(-1)
        d_pose = dx["pose"] * problem_blk.pose_free[:, None]
        d_pt = dx["pt"].reshape(-1, 3) * point_free_w[:, None]
        q = quat.boxplus(params_blk.q, d_pose[:, :3])
        c = params_blk.c + d_pose[:, 3:]
        new = params_blk.replace(q=q, c=c, points=params_blk.points + d_pt)
        step_norm = jnp.sqrt(jnp.sum(d_pose ** 2)
                             + _psum(jnp.sum(d_pt ** 2)))
        x_norm = jnp.sqrt(
            jnp.sum(params_blk.c ** 2) + _psum(jnp.sum(params_blk.points ** 2))
            + jnp.sum(params_blk.q ** 2) + jnp.sum(params_blk.intr ** 2))
        return new, step_norm, x_norm

    def cost_blk(plan_blk, problem_blk, params_blk):
        return _psum(banded.cost_only(_local(plan_blk), problem_blk,
                                      params_blk))

    def cost_decrease_blk(plan_blk, problem_blk, p_old, p_new):
        return _psum(banded.cost_decrease(_local(plan_blk), problem_blk,
                                          p_old, p_new))

    def error_stats_blk(plan_blk, problem_blk, params_blk):
        stats = banded.error_stats(_local(plan_blk), problem_blk,
                                   params_blk, thresh)
        return tuple(_psum(s) for s in stats)

    # --- shard_map + jit wrappers ----------------------------------------------

    def smap(f, in_specs, out_specs):
        g = jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False)
        jf = jax.jit(g)

        def call(*args):
            with jax.default_matmul_precision(options.matmul_precision):
                return jf(*args)

        return call

    _prepare = smap(prepare_blk, (plan_spec, prob_spec, par_spec_int),
                    aux_specs())
    _solve = smap(solve_step_blk, (plan_spec, aux_specs(), P()),
                  (step_spec, P(), P()))
    _apply = smap(_apply_step_blk,
                  (plan_spec, prob_spec, par_spec_int, step_spec),
                  (par_spec_int, P(), P()))
    _cost = smap(cost_blk, (plan_spec, prob_spec, par_spec_int), P())
    _cost_dec = smap(cost_decrease_blk,
                     (plan_spec, prob_spec, par_spec_int, par_spec_int),
                     P())
    _stats = smap(error_stats_blk, (plan_spec, prob_spec, par_spec_int),
                  (P(), P(), P(), P()))

    # to_internal / to_external run on replicated (global) arrays outside
    # shard_map — the gather/scatter permutation needs the whole plan.
    pt_sharding = NamedSharding(mesh, P(axis))

    def to_internal(params: Params) -> Params:
        pts = plan.gather_points(params.points).reshape(-1, 3)
        pts = jax.device_put(pts, pt_sharding)
        rep = NamedSharding(mesh, P())
        return Params(q=jax.device_put(params.q, rep),
                      c=jax.device_put(params.c, rep),
                      intr=jax.device_put(params.intr, rep),
                      points=pts)

    def to_external(params: Params) -> Params:
        pts_w = params.points.reshape(plan.NR, plan.G, 3)
        return params.replace(points=plan.scatter_points(pts_w))

    from ..solver.lm import attach_try_step
    return attach_try_step({
        "prepare": lambda p: _prepare(plan_sharded, prob_slim, p),
        "solve_step": lambda aux, radius: _solve(
            plan_sharded, aux,
            jnp.asarray(radius, plan.uv.dtype)),
        "apply_step": lambda p, dx: _apply(plan_sharded, prob_slim, p, dx),
        "cost": lambda p: _cost(plan_sharded, prob_slim, p),
        "cost_decrease": lambda a, b: _cost_dec(plan_sharded, prob_slim,
                                                a, b),
        "error_stats": lambda p: _stats(plan_sharded, prob_slim, p),
        "to_internal": to_internal,
        "to_external": to_external,
        "engine": ("banded_schur", "xla-window-sharded"),
    }, options)
