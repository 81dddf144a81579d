"""Iterative Schur solver: matrix-free PCG on the reduced camera system.

Parity: Ceres ``ITERATIVE_SCHUR`` — ``IterativeSchurComplementSolver`` +
``ConjugateGradientsSolver`` + ``SchurJacobiPreconditioner`` (SURVEY.md §2
C15/C16, §3.4 hot loop #3).

Matrix-free formulation: S = B_λ − E C_λ⁻¹ Eᵀ is **never materialized**.
Its matvec is five batched products over the observation axis::

    u   = J_cam · p          (N,2)   gather + per-obs small matmul
    Bp  = J_camᵀ · u         (Dc,)   scatter-add (segment over cameras)
    w   = Σ_obs J_ptᵀ u      (M,3)   segment-sum by point   ( = Eᵀp )
    y   = C_λ⁻¹ w            (M,3)   batched 3×3 solves
    ECy = J_camᵀ (J_pt · y)  (Dc,)   gather + scatter-add

All five are batched elementwise/reduction passes; no indirection beyond
static gathers.  The CG
loop runs entirely on-device in a ``lax.while_loop`` — zero host round-trips
per CG iteration (the "speed-of-light per iteration" requirement,
BASELINE.json north star).

The preconditioner is block-Jacobi on S (Ceres SCHUR_JACOBI): per-pose 6×6
and per-intrinsics ni×ni diagonal blocks of B_λ minus the per-(block, point)
elimination contribution F C_λ⁻¹ Fᵀ, factored once per solve and applied as
batched Cholesky solves.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..problem.types import POSE_DOF, Params, Problem
from . import assembly, flatplan, residuals
from .options import SolverOptions
from .residuals import Evaluation
from .schur import (camera_entries, camera_gradient, camera_jtj_diag,
                    gradient_blocks_planned, invert_3x3_psd,
                    jtj_diag_planned, _lm_scaled_damp, scale_evaluation)


class SchurFreeOperator(NamedTuple):
    """Matrix-free damped reduced camera system S_λ = B_λ − E C_λ⁻¹ Eᵀ.

    ``plans`` (solver/flatplan.py) replaces the duplicate-index
    scatter/segment_sum reductions with gather + dense slot-sum;
    plans=None keeps the legacy scatter forms (the sharded
    solver's per-shard kernels build their own reductions).
    """
    ev: Evaluation
    problem: Problem
    shapes: assembly.TangentShapes
    lm_cam: jax.Array      # (Dc,) LM diagonal for the camera block
    C_inv: jax.Array       # (M,3,3) damped point-block inverses
    plans: object = None   # Optional[flatplan.FlatPlans]

    def _jcam_apply(self, p: jax.Array) -> jax.Array:
        """u = J_cam · p over all observations → (N, 2)."""
        entries = camera_entries(self.ev, self.problem, self.shapes)
        u = jnp.zeros(self.ev.r.shape, self.ev.r.dtype)
        for e in entries:
            cols = e.base[:, None] + jnp.arange(e.width)[None, :]
            u = u + jnp.einsum("nrw,nw->nr", e.J, p[cols])
        return u

    def _jcam_transpose_apply(self, u: jax.Array) -> jax.Array:
        """J_camᵀ · u reduced into the camera tangent vector → (Dc,)."""
        if self.plans is not None:
            from .schur import _grad_cols
            pl = self.plans
            ev = self.ev
            Hx_pose = pl.pose_a.reduce_cols(
                _grad_cols(ev.J_pose[:, :, 0, :], u))
            if pl.pose_b is not None:
                Hx_pose = Hx_pose + pl.pose_b.reduce_cols(
                    _grad_cols(ev.J_pose[:, :, 1, :], u))
            parts = [Hx_pose.reshape(-1)]
            if self.shapes.ni > 0:
                parts.append(pl.intr.reduce_cols(
                    _grad_cols(ev.J_intr, u)).reshape(-1))
            return (jnp.concatenate(parts) if len(parts) > 1 else parts[0])
        out = jnp.zeros((self.shapes.cam_dim,), u.dtype)
        for e in camera_entries(self.ev, self.problem, self.shapes):
            cols = e.base[:, None] + jnp.arange(e.width)[None, :]
            out = out.at[cols].add(jnp.einsum("nrw,nr->nw", e.J, u))
        return out

    def _pt_reduce(self, u: jax.Array) -> jax.Array:
        """Σ_obs J_ptᵀ u per point → (M, 3)."""
        if self.plans is not None:
            from .schur import _grad_cols
            return self.plans.point.reduce_cols(_grad_cols(self.ev.J_pt, u))
        return jax.ops.segment_sum(
            jnp.einsum("nrd,nr->nd", self.ev.J_pt, u),
            self.problem.obs.point, num_segments=self.shapes.n_points)

    def et_apply(self, p: jax.Array) -> jax.Array:
        """Eᵀ·p = Σ_obs J_ptᵀ (J_cam p) per point → (M, 3)."""
        return self._pt_reduce(self._jcam_apply(p))

    def e_apply(self, y: jax.Array) -> jax.Array:
        """E·y = J_camᵀ (J_pt · y[point]) → (Dc,)."""
        v = jnp.einsum("nrd,nd->nr", self.ev.J_pt,
                       y[self.problem.obs.point])
        return self._jcam_transpose_apply(v)

    def matvec(self, p: jax.Array) -> jax.Array:
        """q = S_λ · p (one fused pass: shares the J_cam·p product)."""
        u = self._jcam_apply(p)
        Bp = self._jcam_transpose_apply(u) + self.lm_cam * p
        w = self._pt_reduce(u)
        y = jnp.einsum("mab,mb->ma", self.C_inv, w)
        return Bp - self.e_apply(y)

    def back_substitute(self, dc: jax.Array, g_pt: jax.Array) -> jax.Array:
        """dp = C_λ⁻¹ (−g_pt − Eᵀ dc) — landmark recovery after camera solve."""
        w = -g_pt - self.et_apply(dc)
        return jnp.einsum("mab,mb->ma", self.C_inv, w)


# --- Schur-Jacobi preconditioner --------------------------------------------

def schur_jacobi_partial(ev: Evaluation, problem: Problem,
                         shapes: assembly.TangentShapes, C_inv: jax.Array,
                         plans=None):
    """Block diagonal of S (undamped): per-pose (P,6,6), per-intr (K,ni,ni).

    Exact B diagonal blocks; the E C⁻¹ Eᵀ part is accumulated per
    observation (exact when each (camera block, point) pair is observed
    once — the usual case; otherwise still a valid SPD preconditioner,
    matching the quality Ceres's SCHUR_JACOBI provides).  In the sharded
    solver these partials are psum'd before the LM diagonal is added.
    """
    obs = problem.obs
    pt = obs.point
    P, ni, K = shapes.n_poses, shapes.ni, shapes.n_intr

    if plans is not None:
        # Column-component form (see schur._col_products layout note):
        # C⁻¹ gathered per obs as 6 symmetric (N,) columns, F = J_camᵀJ_pt
        # as w·3 columns, every (w, v) output component an unrolled
        # elementwise chain — no tiny-minor block tensors.
        sym = {(0, 0): 0, (0, 1): 1, (1, 0): 1, (0, 2): 2, (2, 0): 2,
               (1, 1): 3, (1, 2): 4, (2, 1): 4, (2, 2): 5}
        ci_flat = C_inv.reshape(C_inv.shape[0], 9)
        ci_cols = [ci_flat[:, 3 * p + q][pt]
                   for (p, q) in [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                  (2, 2)]]
        Jp = ev.J_pt

        def block_planned(J, plan):
            w_dim = J.shape[2]
            nr = J.shape[1]
            f = [[sum(J[:, r, w] * Jp[:, r, p] for r in range(nr))
                  for p in range(3)] for w in range(w_dim)]
            comps = []
            for w in range(w_dim):
                for v in range(w_dim):
                    bb = sum(J[:, r, w] * J[:, r, v] for r in range(nr))
                    fcf = sum(f[w][p] * ci_cols[sym[(p, q)]] * f[v][q]
                              for p in range(3) for q in range(3))
                    comps.append(bb - fcf)
            out = plan.reduce_cols(jnp.stack(comps, axis=0))
            return out.reshape(-1, w_dim, w_dim)

        D_pose = block_planned(ev.J_pose[:, :, 0, :], plans.pose_a)
        if problem.model.rolling_shutter:
            D_pose = D_pose + block_planned(ev.J_pose[:, :, 1, :],
                                            plans.pose_b)
        if ni > 0:
            D_intr = block_planned(ev.J_intr, plans.intr)
        else:
            D_intr = jnp.zeros((K, 0, 0), ev.r.dtype)
        return D_pose, D_intr

    def pose_block(J, idx):
        bb = jnp.einsum("nri,nrk->nik", J, J)
        f = jnp.einsum("nrw,nrp->nwp", J, ev.J_pt)          # F = J_camᵀ J_pt
        fcf = jnp.einsum("nwp,npq,nvq->nwv", f, C_inv[pt], f)
        return (jax.ops.segment_sum(bb - fcf, idx, num_segments=P))

    D_pose = pose_block(ev.J_pose[:, :, 0, :], obs.pose_a)
    if problem.model.rolling_shutter:
        D_pose = D_pose + pose_block(ev.J_pose[:, :, 1, :], obs.pose_b)

    if ni > 0:
        bb = jnp.einsum("nri,nrk->nik", ev.J_intr, ev.J_intr)
        f = jnp.einsum("nrw,nrp->nwp", ev.J_intr, ev.J_pt)
        fcf = jnp.einsum("nwp,npq,nvq->nwv", f, C_inv[pt], f)
        D_intr = jax.ops.segment_sum(bb - fcf, obs.intr_idx,
                                     num_segments=K)
    else:
        D_intr = jnp.zeros((K, 0, 0), ev.r.dtype)
    return D_pose, D_intr


def add_lm_diag(D_pose: jax.Array, D_intr: jax.Array, lm_cam: jax.Array,
                shapes: assembly.TangentShapes):
    """Add the LM diagonal (which also pins dead/constant dims to 1)."""
    p6 = shapes.n_poses * POSE_DOF
    lm_pose = lm_cam[:p6].reshape(shapes.n_poses, POSE_DOF)
    D_pose = D_pose + jax.vmap(jnp.diag)(lm_pose)
    if shapes.ni > 0:
        lm_intr = lm_cam[p6:].reshape(shapes.n_intr, shapes.ni)
        D_intr = D_intr + jax.vmap(jnp.diag)(lm_intr)
    return D_pose, D_intr


def schur_jacobi_blocks(ev: Evaluation, problem: Problem,
                        shapes: assembly.TangentShapes, lm_cam: jax.Array,
                        C_inv: jax.Array, plans=None):
    """Damped block diagonal of S_λ (single-device path)."""
    D_pose, D_intr = schur_jacobi_partial(ev, problem, shapes, C_inv, plans)
    return add_lm_diag(D_pose, D_intr, lm_cam, shapes)


def make_block_preconditioner(D_pose: jax.Array, D_intr: jax.Array,
                              shapes: assembly.TangentShapes):
    """Factor the diagonal blocks once; return M⁻¹·r as batched cho_solves."""
    L_pose = jax.vmap(jnp.linalg.cholesky)(D_pose)
    ni = shapes.ni
    L_intr = jax.vmap(jnp.linalg.cholesky)(D_intr) if ni > 0 else None
    p6 = shapes.n_poses * POSE_DOF

    def apply(r: jax.Array) -> jax.Array:
        rp = r[:p6].reshape(shapes.n_poses, POSE_DOF)
        zp = jax.vmap(lambda L, b: jax.scipy.linalg.cho_solve((L, True), b))(
            L_pose, rp).reshape(-1)
        if ni > 0:
            ri = r[p6:].reshape(shapes.n_intr, ni)
            zi = jax.vmap(
                lambda L, b: jax.scipy.linalg.cho_solve((L, True), b))(
                    L_intr, ri).reshape(-1)
            return jnp.concatenate([zp, zi])
        return zp

    return apply


# --- PCG loop (on-device, lax.while_loop) -----------------------------------

def pcg(matvec, precond, b: jax.Array, max_iterations: int, eta: float):
    """Preconditioned CG on S_λ x = b; returns (x, final residual, iters).

    Stopping: ‖r‖ ≤ η‖b‖ (Ceres's per-solve r-tolerance forcing) or
    max_iterations.  Runs fully on-device.
    """
    bnorm = jnp.linalg.norm(b)
    tol = eta * bnorm

    def cond(state):
        k, x, r, p, rz, rnorm = state
        return jnp.logical_and(k < max_iterations, rnorm > tol)

    def body(state):
        k, x, r, p, rz, _ = state
        q = matvec(p)
        pq = jnp.dot(p, q)
        # Guard: if the operator has lost positive definiteness in f32,
        # freeze (α=0) rather than produce NaNs; LM will shrink the radius.
        alpha = jnp.where(pq > 0, rz / pq, 0.0)
        x = x + alpha * p
        r = r - alpha * q
        z = precond(r)
        rz_new = jnp.dot(r, z)
        beta = jnp.where(rz > 0, rz_new / rz, 0.0)
        p = z + beta * p
        stalled = jnp.logical_or(pq <= 0, rz <= 0)
        rnorm = jnp.where(stalled, -1.0, jnp.linalg.norm(r))
        return k + 1, x, r, p, rz_new, rnorm

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    state = (jnp.asarray(0, jnp.int32), x0, r0, z0, jnp.dot(r0, z0), bnorm)
    k, x, r, p, rz, _ = jax.lax.while_loop(cond, body, state)
    return x, r, k


# --- LM-driver plug-in -------------------------------------------------------

def make_iterative_schur_solver(problem: Problem, options: SolverOptions):
    """(prepare, solve_step) for the LM driver — ITERATIVE_SCHUR equivalent.

    preconditioner="cluster_jacobi" enables the visibility-clustered
    tier (solver/cluster.py — Ceres CLUSTER_JACOBI parity for unordered
    problems): camera clusters from greedy co-visibility agglomeration,
    per-cluster dense blocks of S factored batched.  (On RS problems the
    cluster coupling is built from the pose_a Jacobian side only — an
    approximation that stays a valid SPD preconditioner; RS video
    problems normally route to the banded engine's segment tier.)
    """
    def _static_shapes():
        return assembly.TangentShapes(
            problem.pose_free.shape[0], problem.intr_free.shape[0],
            problem.intr_tangent_dim, problem.point_free.shape[0])

    from . import flatcols
    # Cols path: pre-permuted observation axis, one-hot matmul fetches —
    # no observation-sized gathers (see flatcols module docstring).  The
    # cluster_jacobi preconditioner assembles from the legacy Evaluation
    # layout, so it keeps the legacy path.
    cplan = None
    if options.preconditioner != "cluster_jacobi":
        try:
            cplan = flatcols.build_cols_plan(problem, problem.obs.uv.dtype)
        except ValueError:
            cplan = None
    plans = None
    cluster_plan = None
    if cplan is None:
        plans = flatplan.build_flat_plans(problem,
                                          problem.intr_tangent_dim)
        if options.preconditioner == "cluster_jacobi":
            from . import cluster as cluster_mod
            cluster_plan = cluster_mod.build_cluster_plan(problem,
                                                          plans.point)

    def _scaling(d_cam, C_diag):
        if options.jacobi_scaling:
            s_cam = jnp.where(
                d_cam > 0, 1.0 / (1.0 + jnp.sqrt(jnp.maximum(d_cam, 0.0))),
                1.0)
            s_pt = jnp.where(
                C_diag > 0, 1.0 / (1.0 + jnp.sqrt(jnp.maximum(C_diag, 0.0))),
                1.0)
        else:
            s_cam = jnp.ones_like(d_cam)
            s_pt = jnp.ones_like(C_diag)
        return s_cam, s_pt

    def _aux(ev, g_pose, g_intr, g_pt, C, d_cam_s, s_cam, s_pt):
        g_cam = jnp.concatenate([g_pose.reshape(-1), g_intr.reshape(-1)])
        gmax = jnp.maximum(
            jnp.max(jnp.abs(g_cam / jnp.where(s_cam == 0, 1.0, s_cam))),
            jnp.max(jnp.abs(g_pt / jnp.where(s_pt == 0, 1.0, s_pt))))
        return {
            "cost": ev.cost, "ev": ev, "g_cam": g_cam, "g_pt": g_pt,
            "C": C, "d_cam": d_cam_s, "s_cam": s_cam, "s_pt": s_pt,
            "gradient_max_norm": gmax,
        }

    def prepare_cols(params: Params):
        ev = flatcols.evaluate_cols(params, problem, cplan)
        d_cam, C_diag = flatcols.jtj_diag_cols(ev, cplan)
        s_cam, s_pt = _scaling(d_cam, C_diag)
        ev = flatcols.scale_cols(ev, cplan, s_cam, s_pt)
        g_pose, g_intr, g_pt = flatcols.gradient_cols(ev, cplan)
        C = flatcols.point_hessian_cols(ev, cplan)
        d_cam_s = flatcols.jtj_diag_cols(ev, cplan)[0]
        return _aux(ev, g_pose, g_intr, g_pt, C, d_cam_s, s_cam, s_pt)

    def prepare_legacy(params: Params):
        ev = residuals.evaluate(params, problem, with_jacobians=True)
        shapes = _static_shapes()
        d_cam, C_diag = jtj_diag_planned(ev, problem, shapes, plans)
        s_cam, s_pt = _scaling(d_cam, C_diag)
        ev = scale_evaluation(ev, problem, shapes, s_cam,
                              s_pt.reshape(-1))
        g_pose, g_intr, g_pt = gradient_blocks_planned(ev, problem,
                                                       shapes, plans)
        from .schur import point_hessian_planned
        C = point_hessian_planned(ev, plans)
        d_cam_s = jtj_diag_planned(ev, problem, shapes, plans)[0]
        return _aux(ev, g_pose, g_intr, g_pt, C, d_cam_s, s_cam, s_pt)

    prepare = prepare_cols if cplan is not None else prepare_legacy

    def solve_step(aux, radius):
        ev = aux["ev"]
        shapes = _static_shapes()
        M = shapes.n_points
        g_cam, g_pt, C = aux["g_cam"], aux["g_pt"], aux["C"]

        lm_cam, _ = _lm_scaled_damp(aux["d_cam"], radius, options)
        c_diag = jnp.diagonal(C, axis1=-2, axis2=-1).reshape(-1)
        lm_pt, _ = _lm_scaled_damp(c_diag, radius, options)
        lm_pt_b = lm_pt.reshape(M, 3)
        C_l = C + jax.vmap(jnp.diag)(lm_pt_b)
        # Barrier: keep the closed-form inverse out of downstream matmul
        # operand fusions (see schur.py).
        C_inv = jax.lax.optimization_barrier(invert_3x3_psd(C_l))

        if cplan is not None:
            def e_apply(y):
                return flatcols.jcam_t_apply_cols(
                    ev, cplan, flatcols.jpt_apply_cols(ev, cplan, y))

            def matvec(p):
                u = flatcols.jcam_apply_cols(ev, cplan, p)
                Bp = flatcols.jcam_t_apply_cols(ev, cplan, u) + lm_cam * p
                w = flatcols.jpt_t_apply_cols(ev, cplan, u)
                y = jnp.einsum("mab,mb->ma", C_inv, w)
                return Bp - e_apply(y)

            def back_substitute(dc, g_pt):
                u = flatcols.jcam_apply_cols(ev, cplan, dc)
                w = -g_pt - flatcols.jpt_t_apply_cols(ev, cplan, u)
                return jnp.einsum("mab,mb->ma", C_inv, w)

            D_pose, D_intr = flatcols.schur_jacobi_cols(ev, cplan, C_inv)
            D_pose, D_intr = add_lm_diag(D_pose, D_intr, lm_cam, shapes)
        else:
            op = SchurFreeOperator(ev=ev, problem=problem, shapes=shapes,
                                   lm_cam=lm_cam, C_inv=C_inv, plans=plans)
            e_apply = op.e_apply
            matvec = op.matvec
            back_substitute = op.back_substitute
            D_pose, D_intr = schur_jacobi_blocks(ev, problem, shapes,
                                                 lm_cam, C_inv, plans)

        # Reduced rhs: b = −g_cam − E C_λ⁻¹ (−g_pt).
        y0 = jnp.einsum("mab,mb->ma", C_inv, -g_pt)
        b = -g_cam - e_apply(y0)

        if cluster_plan is not None:
            from . import cluster as cluster_mod
            precond = cluster_mod.make_cluster_preconditioner(
                cluster_plan, D_pose, D_intr, shapes, ev, problem, C_inv)
        elif options.preconditioner == "schur_jacobi":
            precond = make_block_preconditioner(D_pose, D_intr, shapes)
        else:
            precond = partial(_jacobi_apply, D_pose, D_intr, shapes)

        dc, r_cg, iters = pcg(matvec, precond, b,
                              options.max_cg_iterations, options.cg_eta)
        dp = back_substitute(dc, g_pt)

        # Predicted decrease: the cancellation-free exact-solve identity
        # ½(δᵀλD²δ − gᵀδ) corrected by the CG residual: the full damped
        # system residual is (r_cg in camera rows, 0 in point rows), giving
        # predicted = identity − ½ r_cgᵀ dc  (see schur.py for the identity).
        gTdx = g_cam @ dc + jnp.sum(g_pt * dp)
        dDd = jnp.sum(lm_cam * dc * dc) + jnp.sum(lm_pt_b * dp * dp)
        predicted = 0.5 * (dDd - gTdx) - 0.5 * jnp.dot(r_cg, dc)

        dx_cam_u = aux["s_cam"] * dc
        dx_pt_u = aux["s_pt"] * dp
        dx = jnp.concatenate([dx_cam_u, dx_pt_u.reshape(-1)])
        return dx, predicted, iters

    if cplan is not None:
        prepare.extras = flatcols.make_extras(problem, cplan)
    return prepare, solve_step


def _jacobi_apply(D_pose, D_intr, shapes, r):
    """Plain point-Jacobi fallback: divide by the block diagonals' diagonal."""
    p6 = shapes.n_poses * POSE_DOF
    d_pose = jnp.diagonal(D_pose, axis1=-2, axis2=-1).reshape(-1)
    if shapes.ni > 0:
        d_intr = jnp.diagonal(D_intr, axis1=-2, axis2=-1).reshape(-1)
        d = jnp.concatenate([d_pose, d_intr])
    else:
        d = d_pose
    return r / jnp.maximum(d, 1e-30)
