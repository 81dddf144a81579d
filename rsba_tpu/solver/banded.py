"""Banded Schur solver on the window layout — the video hot path.

Parity: Ceres ``ITERATIVE_SCHUR`` (SURVEY.md §2 C13-C16, §3.4) re-designed
for the structure of video bundle adjustment: feature tracks span bounded
pose windows, so the reduced camera system S = B_λ − E C_λ⁻¹ Eᵀ is **block
banded** along the trajectory (bandwidth = window span W).  Instead of
Ceres's block-sparse scatter (or round 1's matrix-free gather/scatter
matvec), this solver:

* evaluates residuals + Jacobians in the window layout (window.py) — no
  per-observation gathers;
* assembles g, C (per-point 3×3), F (per-point camera-window blocks) and
  the S band with one-hot window contractions + row-level folds — no
  observation-sized scatters;
* **materializes S as a (P, W, 6, 6) symmetric band** (a few MB even at
  10k poses), so each PCG matvec is two small einsums over the band —
  microseconds instead of a full pass over the Jacobian;
* preconditions with Schur-Jacobi = the band's d=0 diagonal blocks.

The Jacobian is consumed entirely inside ``prepare`` (assembly) — it never
participates in the CG loop, which is what makes the per-iteration cost
independent of the observation count.

Algebraic Jacobi scaling: rather than rescaling J and re-assembling, the
assembled quantities are scaled directly (B' = DBD etc.) — equivalent to
Ceres's column scaling at zero extra passes over observation-sized data.

Requires a WindowPlan (video-style problems, single fixed intrinsics
block); ``lm.make_solver_fns`` falls back to the flat solvers otherwise.
Internal parameter layout: ``Params`` with ``points`` in the padded
(NR·G, 3) window order — ``to_internal``/``to_external`` convert.

All jitted phases take (plan, problem) as *arguments*, so the plan's
observation-sized arrays are runtime inputs, never captured constants.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera
from ..geometry import quaternion as quat
from ..problem.types import POSE_DOF, Params, Problem
from ..pytree import pytree_dataclass
from .options import SolverOptions
from .pcg import pcg
from .schur import _lm_scaled_damp, invert_3x3_psd
from .window import WindowPlan


@pytree_dataclass
class WEvaluation:
    """Triggs-corrected residuals + block Jacobians in window layout."""
    r: jax.Array      # (NR, G, L, 2)
    cost: jax.Array   # scalar
    J_pa: jax.Array   # (NR, G, L, 2, 6)
    J_pb: jax.Array   # (NR, G, L, 2, 6)
    J_pt: jax.Array   # (NR, G, L, 2, 3)


def _slot_pose_data(params: Params, plan: WindowPlan):
    """Per-slot (qa, ca, qb, cb) via one one-hot window select per side."""
    win = jnp.concatenate([plan.pose_windows(params.q),
                           plan.pose_windows(params.c)], axis=-1)
    sa = plan.select_a(win)               # (NR, G, L, 7)
    sb = plan.select_b(win)
    return sa[..., :4], sa[..., 4:], sb[..., :4], sb[..., 4:]


def _slot_intr(params: Params, plan: WindowPlan):
    """Intrinsics per slot; the plan guarantees a single block."""
    return params.intr[0][None, None, None, :]


def _points_w(params: Params, plan: WindowPlan) -> jax.Array:
    """Internal padded points (NR, G, 3) from internal params."""
    return params.points.reshape(plan.NR, plan.G, 3)


def to_internal(params: Params, plan: WindowPlan) -> Params:
    """External (M, 3) point order → padded window order (NR·G, 3)."""
    pts = plan.gather_points(params.points).reshape(-1, 3)
    return params.replace(points=pts)


def to_external(params: Params, plan: WindowPlan) -> Params:
    """Padded window order → external (M, 3) point order."""
    pts_w = params.points.reshape(plan.NR, plan.G, 3)
    return params.replace(points=plan.scatter_points(pts_w))


def residuals_raw(params: Params, plan: WindowPlan, problem: Problem
                  ) -> jax.Array:
    """(NR, G, L, 2) uncorrected reprojection residuals (unmasked)."""
    qa, ca, qb, cb = _slot_pose_data(params, plan)
    intr = _slot_intr(params, plan)
    X = _points_w(params, plan)[:, :, None, :]
    proj = camera.project(qa, ca, qb, cb, intr, X, plan.t, problem.model)
    return proj - plan.uv


def cost_only(plan: WindowPlan, problem: Problem, params: Params):
    r = residuals_raw(params, plan, problem)
    s = jnp.sum(r * r, axis=-1)
    rho, _, _ = problem.loss.evaluate(s)
    # Selection, not multiplication: padded slots gather a sentinel point
    # that can project degenerately (0/0 → NaN) — e.g. the gauge-fixed
    # first camera at the origin — and mask·NaN would poison the sum.
    return 0.5 * jnp.sum(jnp.where(plan.mask > 0, rho, 0.0))


def cost_decrease(plan: WindowPlan, problem: Problem, p_old: Params,
                  p_new: Params):
    """Pairwise-differenced robust cost decrease (f32-safe, see
    residuals.cost_decrease)."""
    r_old = residuals_raw(p_old, plan, problem)
    r_new = residuals_raw(p_new, plan, problem)
    rho_old, _, _ = problem.loss.evaluate(jnp.sum(r_old * r_old, axis=-1))
    rho_new, _, _ = problem.loss.evaluate(jnp.sum(r_new * r_new, axis=-1))
    return 0.5 * jnp.sum(jnp.where(plan.mask > 0, rho_old - rho_new, 0.0))


def error_stats(plan: WindowPlan, problem: Problem, params: Params,
                inlier_threshold: float):
    r = residuals_raw(params, plan, problem)
    s = jnp.sum(r * r, axis=-1)
    m = plan.mask
    s = jnp.where(m > 0, s, 0.0)          # block NaN from padded slots
    inl = m * (s <= inlier_threshold * inlier_threshold)
    return (jnp.sum(s), jnp.sum(m), jnp.sum(inl * s), jnp.sum(inl))


def evaluate(params: Params, plan: WindowPlan, problem: Problem
             ) -> WEvaluation:
    """Residuals + tangent-space Jacobians for every slot (jacfwd+vmap).

    Masking: slot mask on r/J; pose/point free masks zero J columns
    (Ceres SetParameterBlockConstant semantics), matching the flat
    evaluator (residuals.evaluate)."""
    qa, ca, qb, cb = _slot_pose_data(params, plan)
    intr = jnp.broadcast_to(_slot_intr(params, plan),
                            plan.t.shape + (params.intr.shape[-1],))
    X = jnp.broadcast_to(_points_w(params, plan)[:, :, None, :],
                         plan.t.shape + (3,))
    model = problem.model
    dtype = params.points.dtype
    zeros = (jnp.zeros(POSE_DOF, dtype), jnp.zeros(POSE_DOF, dtype),
             jnp.zeros(3, dtype))

    def f(d_pa, d_pb, d_pt, qa, ca, qb, cb, intr, X, uv, t):
        qa2 = quat.boxplus(qa, d_pa[:3])
        ca2 = ca + d_pa[3:]
        qb2 = quat.boxplus(qb, d_pb[:3])
        cb2 = cb + d_pb[3:]
        return camera.project(qa2, ca2, qb2, cb2, intr, X + d_pt, t,
                              model) - uv

    def one(qa, ca, qb, cb, intr, X, uv, t):
        r = f(*zeros, qa, ca, qb, cb, intr, X, uv, t)
        J = jax.jacfwd(f, argnums=(0, 1, 2))(
            *zeros, qa, ca, qb, cb, intr, X, uv, t)
        return r, J

    S = plan.n_slots
    flat = lambda a: a.reshape((S,) + a.shape[3:])  # noqa: E731
    r, (J_pa, J_pb, J_pt) = jax.vmap(one)(
        flat(qa), flat(ca), flat(qb), flat(cb), flat(intr), flat(X),
        flat(plan.uv), flat(plan.t))

    J_full = jnp.concatenate([J_pa, J_pb, J_pt], axis=-1)   # (S, 2, 15)
    rt, Jt, rho = problem.loss.correct(r, J_full)
    mask_f = flat(plan.mask)
    # where-selection (not multiplication) so NaN from degenerately
    # projecting padded slots cannot reach cost or normal equations.
    cost = 0.5 * jnp.sum(jnp.where(mask_f > 0, rho, 0.0))
    rt = jnp.where(mask_f[:, None] > 0, rt, 0.0)
    Jt = jnp.where(mask_f[:, None, None] > 0, Jt, 0.0)
    J_pa, J_pb, J_pt = jnp.split(Jt, [POSE_DOF, 2 * POSE_DOF], axis=-1)

    grid = (plan.NR, plan.G, plan.L)
    r = rt.reshape(grid + (2,))
    J_pa = J_pa.reshape(grid + (2, POSE_DOF))
    J_pb = J_pb.reshape(grid + (2, POSE_DOF))
    J_pt = J_pt.reshape(grid + (2, 3))

    # Constant-block masks.
    pf_w = plan.pose_windows(problem.pose_free)      # (NR, W)
    J_pa = J_pa * plan.select_a(pf_w)[..., None, None]
    J_pb = J_pb * plan.select_b(pf_w)[..., None, None]
    ptf = plan.gather_point_scalar(problem.point_free)
    J_pt = J_pt * ptf[:, :, None, None, None]
    return WEvaluation(r=r, cost=cost, J_pa=J_pa, J_pb=J_pb, J_pt=J_pt)


class BandAssembly(NamedTuple):
    """Everything ``solve_step`` needs; Jacobians already consumed."""
    g_cam: jax.Array    # (P, 6)
    g_pt: jax.Array     # (NR, G, 3)
    C: jax.Array        # (NR, G, 3, 3)
    F: jax.Array        # (NR, G, W, 6, 3)
    B_band: jax.Array   # (P, W, 6, 6) upper band of B (d = col − row)


def assemble(ev: WEvaluation, plan: WindowPlan) -> BandAssembly:
    """One pass over window-layout Jacobians → banded normal equations."""
    dtype = ev.r.dtype
    oh_a = plan.onehot_a(dtype)                       # (NR, G, L, W)
    oh_b = plan.onehot_b(dtype)

    # Gradient.
    ta = jnp.einsum("sglr,sglra->sgla", ev.r, ev.J_pa)
    tb = jnp.einsum("sglr,sglra->sgla", ev.r, ev.J_pb)
    g_cam = plan.fold(jnp.einsum("sgla,sglw->swa", ta, oh_a)
                      + jnp.einsum("sgla,sglw->swa", tb, oh_b))
    g_pt = jnp.einsum("sglr,sglrp->sgp", ev.r, ev.J_pt)

    # Point blocks and camera-point coupling.
    C = jnp.einsum("sglrp,sglrq->sgpq", ev.J_pt, ev.J_pt)
    fa = jnp.einsum("sglra,sglrp->sglap", ev.J_pa, ev.J_pt)
    fb = jnp.einsum("sglra,sglrp->sglap", ev.J_pb, ev.J_pt)
    F = (jnp.einsum("sglap,sglw->sgwap", fa, oh_a)
         + jnp.einsum("sglap,sglw->sgwap", fb, oh_b))

    # Camera-camera band.  Each observation couples only (pose_a, pose_b),
    # with pose_b − pose_a ∈ {0, 1}: diagonal blocks plus the d=1 band.
    def diag_term(J, oh):
        v = jnp.einsum("sglra,sglrb,sglw->swab", J, J, oh)
        return plan.fold(v)

    B0 = diag_term(ev.J_pa, oh_a) + diag_term(ev.J_pb, oh_b)
    same = (1.0 - plan.rs_ab)[..., None] * oh_a       # pose_b == pose_a
    X0 = plan.fold(jnp.einsum("sglra,sglrb,sglw->swab",
                              ev.J_pa, ev.J_pb, same))
    B0 = B0 + X0 + jnp.swapaxes(X0, -1, -2)
    adj = plan.rs_ab[..., None] * oh_a                # pose_b == pose_a + 1
    B1 = plan.fold(jnp.einsum("sglra,sglrb,sglw->swab",
                              ev.J_pa, ev.J_pb, adj))

    B_band = jnp.zeros((plan.n_poses, plan.W, POSE_DOF, POSE_DOF), dtype)
    B_band = B_band.at[:, 0].set(B0)
    if plan.W > 1:
        B_band = B_band.at[:, 1].set(B1)
    return BandAssembly(g_cam=g_cam, g_pt=g_pt, C=C, F=F, B_band=B_band)


def scale_assembly(a: BandAssembly, plan: WindowPlan, s_cam: jax.Array,
                   s_pt: jax.Array) -> BandAssembly:
    """Algebraic Jacobi column scaling: B' = DBD, F' = D_cam F D_pt, …

    s_cam: (P, 6); s_pt: (NR, G, 3).
    """
    sw = plan.pose_windows(s_cam)                     # (NR, W, 6)
    g_cam = a.g_cam * s_cam
    g_pt = a.g_pt * s_pt
    C = a.C * s_pt[..., :, None] * s_pt[..., None, :]
    F = a.F * sw[:, None, :, :, None] * s_pt[:, :, None, None, :]
    # band: B'[p, d] = diag(s[p]) B[p, d] diag(s[p+d])
    s_plus = _band_shift(s_cam, plan.W)               # (P, W, 6) s[p+d]
    B_band = a.B_band * s_cam[:, None, :, None] * s_plus[:, :, None, :]
    return BandAssembly(g_cam=g_cam, g_pt=g_pt, C=C, F=F, B_band=B_band)


def _band_shift(x: jax.Array, W: int) -> jax.Array:
    """(P, ...) → (P, W, ...) with out[p, d] = x[p + d] (zero padded)."""
    P = x.shape[0]
    xp = jnp.concatenate(
        [x, jnp.zeros((W,) + x.shape[1:], x.dtype)], axis=0)
    return jnp.stack([xp[d:d + P] for d in range(W)], axis=1)


def make_band_preconditioner(S_band: jax.Array, kind: str,
                             segment: int = 16):
    """Preconditioner for PCG on the banded S (both window engines).

    kind = "schur_jacobi": per-pose 6×6 diagonal blocks (Ceres
    SCHUR_JACOBI) — batched Cholesky + cho_solve.

    kind = "cluster_jacobi": contiguous ``segment``-pose blocks of the
    band, each factored dense — the video-trajectory analogue of Ceres's
    visibility-clustered tier (CLUSTER_JACOBI / CLUSTER_TRIDIAGONAL):
    on a trajectory the "clusters" of co-visible cameras ARE contiguous
    pose segments, so the cluster preconditioner is exactly a
    block-diagonal-by-segment slice of the band.  Captures all
    intra-segment coupling (window span W ≤ segment), drops only the
    cross-boundary terms; costs one batched (6·segment)² Cholesky per
    solve and a batched cho_solve per CG iteration.
    """
    P, W = S_band.shape[0], S_band.shape[1]
    if kind in ("jacobi", "schur_jacobi"):
        # Closed-form 6×6 inverses (blocked Schur over invert_3x3_psd):
        # the explicit inverse makes the per-CG-iteration apply one
        # batched (P,6,6)×(P,6) contraction.  Round-
        # off only perturbs the CG convergence rate, never the solution.
        from .schur import invert_6x6_psd
        Minv = invert_6x6_psd(S_band[:, 0])

        def apply(r_flat):
            r = r_flat.reshape(P, POSE_DOF)
            return jnp.einsum("pab,pb->pa", Minv, r).reshape(-1)

        return apply
    if kind != "cluster_jacobi":
        raise ValueError(kind)

    K = min(segment, P)
    nseg = -(-P // K)
    P_pad = nseg * K
    # Segment-dense matrices gathered from the band: M[s, i, j] 6×6 with
    # j − i = d ∈ [0, W).  Padding rows get identity diagonal blocks.
    pad = jnp.zeros((P_pad - P, W, POSE_DOF, POSE_DOF), S_band.dtype)
    pad = pad.at[:, 0].set(jnp.eye(POSE_DOF, dtype=S_band.dtype))
    Sp = jnp.concatenate([S_band, pad], axis=0)       # (P_pad, W, 6, 6)
    M = jnp.zeros((nseg, K, K, POSE_DOF, POSE_DOF), S_band.dtype)
    rows = jnp.arange(P_pad)
    seg_id = rows // K
    i_in = rows % K
    for d in range(min(W, K)):
        j_in = i_in + d
        # Sp rows ≥ P are zero except the d=0 identity, so the only gate
        # needed is the segment boundary.
        ok = j_in < K
        blk = jnp.where(ok[:, None, None], Sp[:, d], 0.0)
        M = M.at[seg_id, i_in, jnp.minimum(j_in, K - 1)].add(blk)
        if d > 0:
            M = M.at[seg_id, jnp.minimum(j_in, K - 1), i_in].add(
                jnp.swapaxes(blk, -1, -2))
    D = K * POSE_DOF
    Md = M.transpose(0, 1, 3, 2, 4).reshape(nseg, D, D)
    Lseg = jax.vmap(jnp.linalg.cholesky)(Md)

    def apply(r_flat):
        r = jnp.concatenate(
            [r_flat, jnp.zeros((P_pad * POSE_DOF - r_flat.shape[0],),
                               r_flat.dtype)]).reshape(nseg, D)
        z = jax.vmap(
            lambda L, v: jax.scipy.linalg.cho_solve((L, True), v))(Lseg, r)
        return z.reshape(-1)[:P * POSE_DOF]

    return apply


def band_matvec(S_band: jax.Array, x: jax.Array) -> jax.Array:
    """q = S·x for the symmetric banded S.  x, q: (P, 6).

    S_band stores the upper band: S[p, p+d] = S_band[p, d], d ∈ [0, W).
    """
    P, W = S_band.shape[0], S_band.shape[1]
    x_plus = _band_shift(x, W)                        # x[p + d]
    up = jnp.einsum("pdab,pdb->pa", S_band, x_plus)
    # down[p] = Σ_{d≥1} S_band[p−d, d]ᵀ x[p−d]
    z = jnp.einsum("pdab,pa->pdb", S_band, x)         # z[p, d] = S[p,d]ᵀx[p]
    down = jnp.zeros_like(x)
    for d in range(1, W):
        down = down.at[d:].add(z[:P - d, d])
    return up + down


def fcf_band(F: jax.Array, plan: WindowPlan, C_inv: jax.Array) -> jax.Array:
    """F C_λ⁻¹ Fᵀ folded into the (P, W, 6, 6) band.

    Point-side only — under the sharded solver each shard computes this
    from its local rows and the partial bands are psum'd."""
    Y = jnp.einsum("sgwax,sgxy->sgway", F, C_inv)     # F C⁻¹
    W = plan.W
    bands = []
    for d in range(W):
        v = jnp.einsum("sgway,sgwby->swab", Y[:, :, :W - d], F[:, :, d:])
        if d > 0:
            v = jnp.pad(v, ((0, 0), (0, d), (0, 0), (0, 0)))
        bands.append(plan.fold(v))
    return jnp.stack(bands, axis=1)                   # (P, W, 6, 6)


def schur_band(assembly: BandAssembly, plan: WindowPlan, C_inv: jax.Array,
               lm_cam: jax.Array) -> jax.Array:
    """S_λ band: B_λ − F C_λ⁻¹ Fᵀ folded into (P, W, 6, 6)."""
    S = assembly.B_band - fcf_band(assembly.F, plan, C_inv)
    return S.at[:, 0].add(jax.vmap(jnp.diag)(lm_cam))


def e_apply(F: jax.Array, plan: WindowPlan, y: jax.Array) -> jax.Array:
    """(E·y)_cam: per-point blocks F against point vectors y (NR,G,3)."""
    return plan.fold(jnp.einsum("sgwax,sgx->swa", F, y))


def et_apply(F: jax.Array, plan: WindowPlan, p: jax.Array) -> jax.Array:
    """Eᵀ·p per point: (P,6) camera vector → (NR,G,3)."""
    pw = plan.pose_windows(p)                         # (NR, W, 6)
    return jnp.einsum("sgwax,swa->sgx", F, pw)


def make_banded_schur_solver(options: SolverOptions):
    """(prepare, solve_step) on the window layout for the LM driver.

    Both take (plan, problem) as leading runtime arguments.
    """

    def prepare(plan: WindowPlan, problem: Problem, params: Params):
        with jax.named_scope("evaluate"):
            ev = evaluate(params, plan, problem)
        with jax.named_scope("assemble"):
            a = assemble(ev, plan)

        d_cam = jnp.diagonal(a.B_band[:, 0], axis1=-2, axis2=-1)   # (P,6)
        d_pt = jnp.diagonal(a.C, axis1=-2, axis2=-1)               # (NR,G,3)
        gmax = jnp.maximum(jnp.max(jnp.abs(a.g_cam)),
                           jnp.max(jnp.abs(a.g_pt)))
        if options.jacobi_scaling:
            s_cam = jnp.where(d_cam > 0,
                              1.0 / (1.0 + jnp.sqrt(jnp.maximum(d_cam, 0.0))),
                              1.0)
            s_pt = jnp.where(d_pt > 0,
                             1.0 / (1.0 + jnp.sqrt(jnp.maximum(d_pt, 0.0))),
                             1.0)
            a = scale_assembly(a, plan, s_cam, s_pt)
        else:
            s_cam = jnp.ones_like(d_cam)
            s_pt = jnp.ones_like(d_pt)
        return {
            "cost": ev.cost, "a": a, "s_cam": s_cam, "s_pt": s_pt,
            "gradient_max_norm": gmax,
        }

    def solve_step(plan: WindowPlan, aux, radius):
        a: BandAssembly = aux["a"]
        P = plan.n_poses

        d_cam = jnp.diagonal(a.B_band[:, 0], axis1=-2, axis2=-1)
        lm_cam, _ = _lm_scaled_damp(d_cam.reshape(-1), radius, options)
        lm_cam = lm_cam.reshape(P, POSE_DOF)
        c_diag = jnp.diagonal(a.C, axis1=-2, axis2=-1)
        lm_pt, _ = _lm_scaled_damp(c_diag.reshape(-1), radius, options)
        lm_pt = lm_pt.reshape(plan.NR, plan.G, 3)
        C_l = a.C + jax.vmap(jax.vmap(jnp.diag))(lm_pt)
        C_inv = invert_3x3_psd(C_l)

        with jax.named_scope("schur_band"):
            S = schur_band(a, plan, C_inv, lm_cam)

        # Reduced rhs: b = −g_cam − E C_λ⁻¹ (−g_pt).
        y0 = jnp.einsum("sgxy,sgy->sgx", C_inv, -a.g_pt)
        b = -a.g_cam - e_apply(a.F, plan, y0)

        precond = make_band_preconditioner(S, options.preconditioner)

        def matvec(p_flat):
            return band_matvec(S, p_flat.reshape(P, POSE_DOF)).reshape(-1)

        with jax.named_scope("pcg"):
            dc_flat, r_cg, iters = pcg(matvec, precond, b.reshape(-1),
                                       options.max_cg_iterations,
                                       options.cg_eta)
        dc = dc_flat.reshape(P, POSE_DOF)

        # Back-substitute landmarks.
        with jax.named_scope("back_substitute"):
            w = -a.g_pt - et_apply(a.F, plan, dc)
            dp = jnp.einsum("sgxy,sgy->sgx", C_inv, w)

        # Predicted decrease: cancellation-free identity + CG correction
        # (see pcg.py).
        gTdx = jnp.sum(a.g_cam * dc) + jnp.sum(a.g_pt * dp)
        dDd = jnp.sum(lm_cam * dc * dc) + jnp.sum(lm_pt * dp * dp)
        predicted = 0.5 * (dDd - gTdx) - 0.5 * jnp.dot(r_cg, dc_flat)

        dx = {"pose": aux["s_cam"] * dc, "pt": aux["s_pt"] * dp}
        return dx, predicted, iters

    return prepare, solve_step


def make_window_solver_fns(problem: Problem, plan: WindowPlan,
                           options: SolverOptions):
    """Full phase-function dict for lm.solve — window-native end to end.

    Internal params carry points in padded window order; ``to_internal`` /
    ``to_external`` convert at the solve boundary.  The plan and problem
    are bound as *call-time arguments* of the jitted phases (never traced
    constants), so observation-sized data stays out of the executable.
    """
    prepare, solve_step = make_banded_schur_solver(options)
    from .lm import inlier_threshold
    thresh = inlier_threshold(problem)

    def apply_step(plan: WindowPlan, problem: Problem, params: Params, dx):
        point_free_w = plan.gather_point_scalar(
            problem.point_free).reshape(-1)
        d_pose = dx["pose"] * problem.pose_free[:, None]
        d_pt = dx["pt"].reshape(-1, 3) * point_free_w[:, None]
        q = quat.boxplus(params.q, d_pose[:, :3])
        c = params.c + d_pose[:, 3:]
        new = params.replace(q=q, c=c, points=params.points + d_pt)
        step_norm = jnp.sqrt(jnp.sum(d_pose ** 2) + jnp.sum(d_pt ** 2))
        x_norm = jnp.sqrt(
            jnp.sum(params.c ** 2) + jnp.sum(params.points ** 2)
            + jnp.sum(params.q ** 2) + jnp.sum(params.intr ** 2))
        return new, step_norm, x_norm

    def _wrap(f, *bound):
        jf = jax.jit(f)

        def call(*args):
            with jax.default_matmul_precision(options.matmul_precision):
                return jf(*bound, *args)

        call._jitted = jf       # for utils.roofline (XLA cost analysis)
        call._bound = bound
        call._precision = options.matmul_precision
        return call

    raw = {
        "bound": (plan, problem),
        "prepare": lambda b, p: prepare(b[0], b[1], p),
        "solve_step": lambda b, aux, radius: solve_step(b[0], aux, radius),
        "apply_step": lambda b, params, dx: apply_step(
            b[0], b[1], params, dx),
        "cost_decrease": lambda b, po, pn: cost_decrease(b[0], b[1], po, pn),
    }

    return {
        "raw": raw,
        "prepare": _wrap(prepare, plan, problem),
        "solve_step": _wrap(solve_step, plan),
        "apply_step": _wrap(apply_step, plan, problem),
        "cost": _wrap(cost_only, plan, problem),
        "cost_decrease": _wrap(cost_decrease, plan, problem),
        "error_stats": _wrap(
            lambda pl, pr, p: error_stats(pl, pr, p, thresh), plan, problem),
        "to_internal": _wrap(lambda pl, p: to_internal(p, pl), plan),
        "to_external": _wrap(lambda pl, p: to_external(p, pl), plan),
        "engine": ("banded_schur", "xla"),
    }
