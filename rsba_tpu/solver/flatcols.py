"""Column-planes evaluation for the flat solvers.

This module eliminates ALL observation-sized gathers/scatters from the
per-iteration path (the window-layout idea of the banded engine, applied
to the flat layout):

* The observation axis is PRE-PERMUTED into point-slot order at solver
  build (host): N2 = R·L slots, point p's observations contiguous.
  Point-side reductions become reshape + sum — no indexing at all.
* Per-observation parameter/scale fetches are one-hot MATMULS against a
  constant 0/1 matrix (N2, P) built once, instead of gathers.
  Camera-side reductions are the transposed matmuls.
* Point parameters are fetched with ONE (R,)-row gather (R ≈ n_points,
  10–30× cheaper than an observation gather) and broadcast over slots.
* All per-observation data lives in COLUMN layout — (components, N2),
  the huge axis minor — never as tensors with tiny trailing dims.

Whether the one-hot fetches beat plain gathers on the GPU is not
measured yet.

Parity: same math as solver/residuals.py + schur.py (which remain the
portable oracles and the sharded solver's per-shard kernels); the
existing solver tests cross-check the two paths end to end.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import camera, quaternion as quat
from ..problem.types import POSE_DOF, Params, Problem
from ..pytree import pytree_dataclass
from . import flatplan

#: refuse the one-hot path above this (n2 · entities) element count —
#: the constant matrix would not fit comfortably; the factory falls back
#: to the legacy planned path there
OH_MAX_ELEMS = 512 * 1024 * 1024


class ColsPlan(NamedTuple):
    """Host-built permuted-observation plan for the column evaluator."""
    R: int                     # point-slot rows
    L: int                     # slots per row
    n_poses: int
    n_intr: int
    ni: int
    n_points: int
    uv: jax.Array              # (2, N2) permuted measurements
    t: jax.Array               # (N2,)
    mask: jax.Array            # (N2,) 0 on pad slots
    row_point: jax.Array       # (R,) point id per row
    rows_identity: bool        # row_point == arange(M)
    oh_a: jax.Array            # (N2, P) one-hot pose_a
    oh_b: Optional[jax.Array]  # (N2, P) pose_b (rolling shutter)
    oh_i: Optional[jax.Array]  # (N2, K) intrinsics (None when K == 1)
    intr_single: bool
    # unique (pose_a, pose_b) / (pose, intr) pairs for B's cross blocks
    oh_ab: Optional[jax.Array]     # (N2, U)
    ab_pos: Optional[tuple]        # (pos_i (U,), pos_k (U,))
    oh_ai: Optional[jax.Array]
    ai_pos: Optional[tuple]
    oh_bi: Optional[jax.Array]
    bi_pos: Optional[tuple]
    #: permuted index arrays (host reference / debugging)
    pose_a: jax.Array
    pose_b: jax.Array
    intr_idx: jax.Array

    @property
    def n2(self) -> int:
        return self.R * self.L

    # --- point-side reductions: pure reshape + sum ----------------------

    def fold_rows(self, v: jax.Array) -> jax.Array:
        """(..., R) → (..., M) near-unique fold (identity when 1:1)."""
        if self.rows_identity:
            return v
        out = jnp.zeros(v.shape[:-1] + (self.n_points,), v.dtype)
        return out.at[..., self.row_point].add(v)

    def pt_reduce(self, comps: jax.Array) -> jax.Array:
        """(C, N2) → (M, C): reshape-sum over slots, fold rows."""
        s = jnp.sum(comps.reshape(comps.shape[0], self.R, self.L), axis=2)
        return self.fold_rows(s).T

    def pt_broadcast(self, x: jax.Array) -> jax.Array:
        """(M, D) per-point values → (D, N2) per-slot columns."""
        v = x[self.row_point]                        # (R, D) small gather
        v = jnp.broadcast_to(v[:, None, :],
                             (self.R, self.L, x.shape[1]))
        return v.reshape(self.n2, -1).T

    # --- camera-side: one-hot matmuls -----------------------------------

    def cam_reduce(self, oh: jax.Array, comps: jax.Array) -> jax.Array:
        """(C, N2) × (N2, E) → (E, C).

        The optimization barrier materializes the (C, N2) components
        before the matmul: fusing the component producer
        (scaled-Jacobian products) into the matmul operand was observed
        to lose small-magnitude sums on the accelerator this path was
        first built for.  Kept until measured on the GPU.
        """
        comps = jax.lax.optimization_barrier(comps)
        return jax.lax.dot(comps, oh).T

    def cam_fetch(self, oh: jax.Array, table: jax.Array) -> jax.Array:
        """(E, D) per-entity values → (D, N2) per-obs columns."""
        table = jax.lax.optimization_barrier(table)
        return jax.lax.dot(oh, table).T


def _one_hot_np(ids: np.ndarray, n: int, dtype) -> jnp.ndarray:
    oh = np.zeros((ids.shape[0], n), np.float32)
    oh[np.arange(ids.shape[0]), ids] = 1.0
    return jnp.asarray(oh, dtype)


def build_cols_plan(problem: Problem, dtype) -> ColsPlan:
    """Host-side construction (one d2h of the obs index arrays)."""
    obs = problem.obs
    pa = np.asarray(obs.pose_a)
    pb = np.asarray(obs.pose_b)
    ii = np.asarray(obs.intr_idx)
    pt = np.asarray(obs.point)
    uv = np.asarray(obs.uv)
    tt = np.asarray(obs.t)
    mk = np.asarray(obs.mask)
    N = pa.shape[0]
    P = int(problem.pose_free.shape[0])
    K = int(problem.intr_free.shape[0])
    M = int(problem.point_free.shape[0])
    rs = problem.model.rolling_shutter
    ni = problem.intr_tangent_dim

    # Point-slot grouping over REAL observations only (mask > 0): the
    # problem's own padding must not enter the grouping — it would form
    # one giant fake segment and blow the slot width L.
    live = np.nonzero(mk > 0)[0]
    n_live = live.shape[0]
    pa, pb, ii, pt = pa[live], pb[live], ii[live], pt[live]
    uv, tt, mk = uv[live], tt[live], mk[live]
    g = flatplan.build_group_plan(pt, M)
    slots = np.asarray(g.slots)
    rows = np.asarray(g.rows)
    R, L = slots.shape
    order = slots.reshape(-1)
    valid = order < n_live

    def perm(a, fill=0.0):
        ext = np.concatenate([a, np.full((1,) + a.shape[1:], fill,
                                         a.dtype)])
        return ext[np.minimum(order, n_live)]

    pa_p = perm(pa.astype(np.int64), 0).astype(np.int64)
    pb_p = perm(pb.astype(np.int64), 0).astype(np.int64)
    ii_p = perm(ii.astype(np.int64), 0).astype(np.int64)
    uv_p = perm(uv)
    t_p = perm(tt)
    mk_p = np.where(valid, perm(mk), 0.0)

    n2 = R * L
    if n2 * max(P, K) > OH_MAX_ELEMS:
        raise ValueError(
            f"cols plan one-hot would be {n2 * max(P, K) / 2**28:.1f} GiB "
            "(f32); problem too large for the one-hot fetch path")
    oh_dtype = dtype
    # dead slots one-hot to entity 0 — harmless, their mask/Jacobian
    # columns are zero.
    oh_a = _one_hot_np(pa_p, P, oh_dtype)
    oh_b = _one_hot_np(pb_p, P, oh_dtype) if rs else None
    intr_single = (K == 1)
    oh_i = None if intr_single else _one_hot_np(ii_p, K, oh_dtype)

    def pair(ids_i, ids_k, nk):
        upair, idx = np.unique(ids_i * nk + ids_k, return_inverse=True)
        oh = _one_hot_np(idx, len(upair), oh_dtype)
        return oh, (jnp.asarray(upair // nk, jnp.int32),
                    jnp.asarray(upair % nk, jnp.int32))

    oh_ab, ab_pos = pair(pa_p, pb_p, P) if rs else (None, None)
    oh_ai, ai_pos = pair(pa_p, ii_p, K) if ni > 0 else (None, None)
    oh_bi, bi_pos = (pair(pb_p, ii_p, K) if (rs and ni > 0)
                     else (None, None))

    rows_identity = bool(R == M) and bool(
        np.array_equal(rows, np.arange(M)))
    return ColsPlan(
        R=R, L=L, n_poses=P, n_intr=K, ni=ni, n_points=M,
        uv=jnp.asarray(uv_p.T, dtype), t=jnp.asarray(t_p, dtype),
        mask=jnp.asarray(mk_p, dtype),
        row_point=jnp.asarray(rows, jnp.int32),
        rows_identity=rows_identity,
        oh_a=oh_a, oh_b=oh_b, oh_i=oh_i, intr_single=intr_single,
        oh_ab=oh_ab, ab_pos=ab_pos, oh_ai=oh_ai, ai_pos=ai_pos,
        oh_bi=oh_bi, bi_pos=bi_pos,
        pose_a=jnp.asarray(pa_p, jnp.int32),
        pose_b=jnp.asarray(pb_p, jnp.int32),
        intr_idx=jnp.asarray(ii_p, jnp.int32))


@pytree_dataclass
class ColsEval:
    """Column-layout evaluation: residual rows + Jacobian column stacks."""
    r: jax.Array                    # (2, N2) Triggs-corrected, masked
    cost: jax.Array
    rho: jax.Array                  # (N2,) per-slot robust cost (masked 0)
    Ja: jax.Array                   # (2, 6, N2) pose_a columns
    Jb: Optional[jax.Array]         # (2, 6, N2) pose_b (RS)
    Ji: Optional[jax.Array]         # (2, ni, N2)
    Jx: jax.Array                   # (2, 3, N2)


def _fetch(params: Params, problem: Problem, plan: ColsPlan):
    """All per-observation inputs as columns (one-hot matmuls, one
    point-row gather)."""
    pose_pack = jnp.concatenate(
        [params.q, params.c, problem.pose_free[:, None]], axis=1)  # (P,8)
    fa = plan.cam_fetch(plan.oh_a, pose_pack)            # (8, N2)
    qa, ca, pfa = fa[:4], fa[4:7], fa[7]
    if plan.oh_b is not None:
        fb = plan.cam_fetch(plan.oh_b, pose_pack)
        qb, cb, pfb = fb[:4], fb[4:7], fb[7]
    else:
        qb, cb, pfb = qa, ca, pfa
    ipack = jnp.concatenate(
        [params.intr, problem.intr_free[:, None]], axis=1)        # (K,10)
    if plan.intr_single:
        fi = jnp.broadcast_to(ipack[0][:, None], (10, plan.n2))
    else:
        fi = plan.cam_fetch(plan.oh_i, ipack)
    intr, inf = fi[:9], fi[9]
    xpack = jnp.concatenate(
        [params.points, problem.point_free[:, None]], axis=1)     # (M,4)
    fx = plan.pt_broadcast(xpack)                                 # (4,N2)
    X, ptf = fx[:3], fx[3]
    return qa, ca, qb, cb, pfa, pfb, intr, inf, X, ptf


def evaluate_cols(params: Params, problem: Problem,
                  plan: ColsPlan) -> ColsEval:
    """Residuals + tangent Jacobian columns, no observation gathers."""
    qa, ca, qb, cb, pfa, pfb, intr, inf, X, ptf = _fetch(
        params, problem, plan)
    model = problem.model
    basis = problem.intr_basis
    ni = plan.ni
    dtype = params.dtype
    Ct = 2 * POSE_DOF + ni + 3

    def res_one(dall, qa, ca, qb, cb, intr, X, uv, t):
        d_pa, d_pb = dall[:POSE_DOF], dall[POSE_DOF:2 * POSE_DOF]
        d_i = dall[2 * POSE_DOF:2 * POSE_DOF + ni]
        d_x = dall[2 * POSE_DOF + ni:]
        qa2 = quat.boxplus(qa, d_pa[:3])
        qb2 = quat.boxplus(qb, d_pb[:3])
        intr2 = intr + basis @ d_i if ni > 0 else intr
        return camera.project(qa2, ca + d_pa[3:], qb2, cb + d_pb[3:],
                              intr2, X + d_x, t, model) - uv

    zeros = jnp.zeros((Ct,), dtype)
    # map over the MINOR axis (in_axes=1/0) — no transposed row-layout
    # copies of the fetched columns are ever materialized
    args = (qa, ca, qb, cb, intr, X, plan.uv, plan.t)
    axes = (None, 1, 1, 1, 1, 1, 1, 1, 0)
    r = jax.vmap(res_one, in_axes=axes, out_axes=1)(zeros, *args)
    J = jax.vmap(jax.jacfwd(res_one), in_axes=axes,
                 out_axes=2)(zeros, *args)                 # (2, Ct, N2)

    # Triggs correction, column-wise.
    s = jnp.sum(r * r, axis=0)
    rho, rho1, rho2 = problem.loss.evaluate(s)
    sqrt_rho1 = jnp.sqrt(jnp.maximum(rho1, 1e-30))
    d = jnp.maximum(1.0 + 2.0 * s * rho2 / rho1, 0.0)
    alpha = jnp.where(rho2 > 0.0, 1.0 - jnp.sqrt(d), 0.0)
    r_t = (sqrt_rho1 / (1.0 - alpha)) * r
    alpha_over_s = jnp.where(s > 0, alpha / jnp.maximum(s, 1e-30), 0.0)
    rTJ = jnp.einsum("rn,rcn->cn", r, J)
    J_t = sqrt_rho1 * (J - alpha_over_s * r[:, None, :] * rTJ[None])

    m = plan.mask
    r_t = r_t * m
    cost = 0.5 * jnp.sum(m * rho)
    J_t = J_t * m
    Ja = J_t[:, :POSE_DOF] * pfa
    Jb = (J_t[:, POSE_DOF:2 * POSE_DOF] * pfb
          if plan.oh_b is not None else None)
    Ji = (J_t[:, 2 * POSE_DOF:2 * POSE_DOF + ni] * inf if ni > 0 else None)
    Jx = J_t[:, 2 * POSE_DOF + ni:] * ptf
    return ColsEval(r=r_t, cost=cost, rho=m * rho, Ja=Ja, Jb=Jb, Ji=Ji,
                    Jx=Jx)


def rho_cols(params: Params, problem: Problem, plan: ColsPlan):
    """Per-slot robust costs (N2,), masked — one fetch + project pass."""
    qa, ca, qb, cb, _, _, intr, _, X, _ = _fetch(params, problem, plan)
    model = problem.model

    def res_one(qa, ca, qb, cb, intr, X, uv, t):
        return camera.project(qa, ca, qb, cb, intr, X, t, model) - uv

    r = jax.vmap(res_one, in_axes=(1,) * 7 + (0,), out_axes=1)(
        qa, ca, qb, cb, intr, X, plan.uv, plan.t)
    rho, _, _ = problem.loss.evaluate(jnp.sum(r * r, axis=0))
    return plan.mask * rho


def cost_cols(params: Params, problem: Problem, plan: ColsPlan):
    return 0.5 * jnp.sum(rho_cols(params, problem, plan))


def error_stats_cols(params: Params, problem: Problem, plan: ColsPlan,
                     inlier_threshold: float):
    qa, ca, qb, cb, _, _, intr, _, X, _ = _fetch(params, problem, plan)
    model = problem.model

    def res_one(qa, ca, qb, cb, intr, X, uv, t):
        return camera.project(qa, ca, qb, cb, intr, X, t, model) - uv

    r = jax.vmap(res_one, in_axes=(1,) * 7 + (0,), out_axes=1)(
        qa, ca, qb, cb, intr, X, plan.uv, plan.t)
    s = jnp.sum(r * r, axis=0)
    m = plan.mask
    inl = m * (s <= inlier_threshold * inlier_threshold)
    return (jnp.sum(m * s), jnp.sum(m), jnp.sum(inl * s), jnp.sum(inl))


# --- assembly --------------------------------------------------------------

def _prod_cols(Ji: jax.Array, Jk: jax.Array) -> jax.Array:
    """(2, wi, N2), (2, wk, N2) → (wi·wk, N2): Σ_r Ji[r,i]·Jk[r,k]."""
    wi, wk = Ji.shape[1], Jk.shape[1]
    return jnp.stack(
        [sum(Ji[r, i] * Jk[r, k] for r in range(2))
         for i in range(wi) for k in range(wk)], axis=0)


def _grad_cols(J: jax.Array, r: jax.Array) -> jax.Array:
    """(2, w, N2), (2, N2) → (w, N2)."""
    return jnp.stack(
        [sum(J[s, i] * r[s] for s in range(2))
         for i in range(J.shape[1])], axis=0)


def gradient_cols(ev: ColsEval, plan: ColsPlan):
    """(P,6), (K,ni), (M,3)."""
    g_pose = plan.cam_reduce(plan.oh_a, _grad_cols(ev.Ja, ev.r))
    if ev.Jb is not None:
        g_pose = g_pose + plan.cam_reduce(plan.oh_b,
                                          _grad_cols(ev.Jb, ev.r))
    if plan.ni > 0:
        gi = _grad_cols(ev.Ji, ev.r)
        g_intr = (jnp.sum(gi, axis=1)[None, :] if plan.intr_single
                  else plan.cam_reduce(plan.oh_i, gi))
    else:
        g_intr = jnp.zeros((plan.n_intr, 0), ev.r.dtype)
    g_pt = plan.pt_reduce(_grad_cols(ev.Jx, ev.r))
    return g_pose, g_intr, g_pt


def jtj_diag_cols(ev: ColsEval, plan: ColsPlan):
    """camera diag (Dc,), point diag (M, 3)."""

    def sq(J):
        return jnp.stack([sum(J[r, i] ** 2 for r in range(2))
                          for i in range(J.shape[1])], axis=0)

    d_pose = plan.cam_reduce(plan.oh_a, sq(ev.Ja))
    if ev.Jb is not None:
        d_pose = d_pose + plan.cam_reduce(plan.oh_b, sq(ev.Jb))
    parts = [d_pose.reshape(-1)]
    if plan.ni > 0:
        di = sq(ev.Ji)
        d_intr = (jnp.sum(di, axis=1)[None, :] if plan.intr_single
                  else plan.cam_reduce(plan.oh_i, di))
        parts.append(d_intr.reshape(-1))
    d_cam = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    d_pt = plan.pt_reduce(sq(ev.Jx))
    return d_cam, d_pt


def point_hessian_cols(ev: ColsEval, plan: ColsPlan) -> jax.Array:
    Jx = ev.Jx
    comps = jnp.stack(
        [sum(Jx[r, d] * Jx[r, e] for r in range(2))
         for (d, e) in [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]],
        axis=0)
    c6 = plan.pt_reduce(comps)
    a, b, c, d, e, f = (c6[:, i] for i in range(6))
    row0 = jnp.stack([a, b, c], axis=-1)
    row1 = jnp.stack([b, d, e], axis=-1)
    row2 = jnp.stack([c, e, f], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def _diag_embed(blocks: jax.Array) -> jax.Array:
    """(E, w, w) blocks → dense block-diagonal (E·w, E·w), scatter-free.

    Pure broadcast-multiply with an identity mask: chains of `.at[].add`
    scatter placements were observed to miscompile on the accelerator
    this path was first built for; dense construction sidesteps the
    scatter lowering.  Kept until a GPU measurement against plain
    scatter-add decides.  Memory: (E, w, E, w) — fine for the
    camera-entity counts the flat path serves.
    """
    E, w = blocks.shape[0], blocks.shape[1]
    eye = jnp.eye(E, dtype=blocks.dtype)
    out = blocks[:, :, None, :] * eye[:, None, :, None]
    return out.reshape(E * w, E * w)


def _pair_embed(blocks: jax.Array, pos_i: jax.Array, pos_k: jax.Array,
                n_i: int, n_k: int) -> jax.Array:
    """(U, wi, wk) unique-pair blocks → dense (n_i·wi, n_k·wk).

    Two-sided one-hot contraction (scatter-free, see _diag_embed)."""
    U, wi, wk = blocks.shape
    dt = blocks.dtype
    ohi = jax.nn.one_hot(pos_i, n_i, dtype=dt)        # (U, n_i)
    ohk = jax.nn.one_hot(pos_k, n_k, dtype=dt)        # (U, n_k)
    out = jnp.einsum("up,uwv,uk->pwkv", ohi,
                     jax.lax.optimization_barrier(blocks), ohk)
    return out.reshape(n_i * wi, n_k * wk)


def assemble_B_cols(ev: ColsEval, plan: ColsPlan, Dc: int) -> jax.Array:
    p6 = plan.n_poses * POSE_DOF
    ni = plan.ni
    P = plan.n_poses

    def blocks_of(oh, Ji, Jk, single=False):
        wi, wk = Ji.shape[1], Jk.shape[1]
        c = _prod_cols(Ji, Jk)
        red = (jnp.sum(c, axis=1)[None, :] if single
               else plan.cam_reduce(oh, c))
        return red.reshape(-1, wi, wk)

    Bpp = _diag_embed(blocks_of(plan.oh_a, ev.Ja, ev.Ja))
    if ev.Jb is not None:
        Bpp = Bpp + _diag_embed(blocks_of(plan.oh_b, ev.Jb, ev.Jb))
        ab = blocks_of(plan.oh_ab, ev.Ja, ev.Jb)
        cross_ab = _pair_embed(ab, plan.ab_pos[0], plan.ab_pos[1], P, P)
        Bpp = Bpp + cross_ab + cross_ab.T
    if ni == 0:
        return Bpp
    Bii = _diag_embed(blocks_of(plan.oh_i, ev.Ji, ev.Ji,
                                single=plan.intr_single))
    if plan.intr_single:
        pos = (jnp.arange(P, dtype=jnp.int32),
               jnp.zeros((P,), jnp.int32))
        Bpi = _pair_embed(blocks_of(plan.oh_a, ev.Ja, ev.Ji),
                          pos[0], pos[1], P, 1)
        if ev.Jb is not None:
            Bpi = Bpi + _pair_embed(blocks_of(plan.oh_b, ev.Jb, ev.Ji),
                                    pos[0], pos[1], P, 1)
    else:
        Bpi = _pair_embed(blocks_of(plan.oh_ai, ev.Ja, ev.Ji),
                          plan.ai_pos[0], plan.ai_pos[1], P, plan.n_intr)
        if ev.Jb is not None:
            Bpi = Bpi + _pair_embed(
                blocks_of(plan.oh_bi, ev.Jb, ev.Ji),
                plan.bi_pos[0], plan.bi_pos[1], P, plan.n_intr)
    return jnp.block([[Bpp, Bpi], [Bpi.T, Bii]])


def assemble_E_cols(ev: ColsEval, plan: ColsPlan) -> jax.Array:
    """A (M, 3, Dc): per-slot one-hot contraction over L, rows → points."""
    M = plan.n_points
    R, L = plan.R, plan.L

    def part(J, oh, n_e, single=False):
        w = J.shape[1]
        comps = _prod_cols(ev.Jx, J)                 # (3w, N2)
        if single:
            out = jnp.sum(comps.reshape(3 * w, R, L), axis=2)  # (3w, R)
            folded = plan.fold_rows(out)             # (3w, M)
            return folded.T.reshape(M, 3, w)
        g = jax.lax.optimization_barrier(comps).reshape(3 * w, R, L)
        oh3 = oh.reshape(R, L, n_e)
        out = jnp.einsum("crl,rle->cer",
                         g.astype(oh3.dtype), oh3).astype(comps.dtype)
        folded = plan.fold_rows(out)                 # (3w, E, M)
        part = folded.transpose(2, 0, 1).reshape(M, 3, w, n_e)
        return part.transpose(0, 1, 3, 2).reshape(M, 3, n_e * w)

    A = part(ev.Ja, plan.oh_a, plan.n_poses)
    if ev.Jb is not None:
        A = A + part(ev.Jb, plan.oh_b, plan.n_poses)
    if plan.ni > 0:
        Ai = part(ev.Ji, plan.oh_i, plan.n_intr, single=plan.intr_single)
        A = jnp.concatenate([A, Ai.reshape(M, 3, -1)], axis=2)
    return A


def scale_cols(ev: ColsEval, plan: ColsPlan, s_cam: jax.Array,
               s_pt: jax.Array) -> ColsEval:
    """Jacobi column scaling applied to the column stacks.

    s_cam (Dc,), s_pt (M, 3): per-obs scale columns come from the same
    one-hot fetches / point broadcast as the parameters."""
    p6 = plan.n_poses * POSE_DOF
    sa = plan.cam_fetch(plan.oh_a,
                        s_cam[:p6].reshape(plan.n_poses, POSE_DOF))
    Ja = ev.Ja * sa[None]
    Jb = None
    if ev.Jb is not None:
        sb = plan.cam_fetch(plan.oh_b,
                            s_cam[:p6].reshape(plan.n_poses, POSE_DOF))
        Jb = ev.Jb * sb[None]
    Ji = None
    if plan.ni > 0:
        si_tab = s_cam[p6:].reshape(plan.n_intr, plan.ni)
        if plan.intr_single:
            si = jnp.broadcast_to(si_tab[0][:, None],
                                  (plan.ni, plan.n2))
        else:
            si = plan.cam_fetch(plan.oh_i, si_tab)
        Ji = ev.Ji * si[None]
    sx = plan.pt_broadcast(s_pt)
    Jx = ev.Jx * sx[None]
    return ColsEval(r=ev.r, cost=ev.cost, rho=ev.rho, Ja=Ja, Jb=Jb,
                    Ji=Ji, Jx=Jx)


def _apply_entry(J: jax.Array, d: jax.Array) -> jax.Array:
    """(2, w, N2) columns × (w, N2) per-obs vector → (2, N2)."""
    return jnp.stack(
        [sum(J[r, i] * d[i] for i in range(J.shape[1]))
         for r in range(2)], axis=0)


def jcam_apply_cols(ev: ColsEval, plan: ColsPlan,
                    p: jax.Array) -> jax.Array:
    """u = J_cam · p over all observations → (2, N2)."""
    p6 = plan.n_poses * POSE_DOF
    dxp = p[:p6].reshape(plan.n_poses, POSE_DOF)
    u = _apply_entry(ev.Ja, plan.cam_fetch(plan.oh_a, dxp))
    if ev.Jb is not None:
        u = u + _apply_entry(ev.Jb, plan.cam_fetch(plan.oh_b, dxp))
    if plan.ni > 0:
        dxi = p[p6:].reshape(plan.n_intr, plan.ni)
        if plan.intr_single:
            di = jnp.broadcast_to(dxi[0][:, None], (plan.ni, plan.n2))
        else:
            di = plan.cam_fetch(plan.oh_i, dxi)
        u = u + _apply_entry(ev.Ji, di)
    return u


def jcam_t_apply_cols(ev: ColsEval, plan: ColsPlan,
                      u: jax.Array) -> jax.Array:
    """J_camᵀ · u reduced into the camera tangent vector → (Dc,)."""
    Hx_pose = plan.cam_reduce(plan.oh_a, _grad_cols(ev.Ja, u))
    if ev.Jb is not None:
        Hx_pose = Hx_pose + plan.cam_reduce(plan.oh_b,
                                            _grad_cols(ev.Jb, u))
    parts = [Hx_pose.reshape(-1)]
    if plan.ni > 0:
        hi = _grad_cols(ev.Ji, u)
        Hx_intr = (jnp.sum(hi, axis=1)[None, :] if plan.intr_single
                   else plan.cam_reduce(plan.oh_i, hi))
        parts.append(Hx_intr.reshape(-1))
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


def jpt_apply_cols(ev: ColsEval, plan: ColsPlan,
                   y: jax.Array) -> jax.Array:
    """J_pt · y[point] per observation → (2, N2); y (M, 3)."""
    return _apply_entry(ev.Jx, plan.pt_broadcast(y))


def jpt_t_apply_cols(ev: ColsEval, plan: ColsPlan,
                     u: jax.Array) -> jax.Array:
    """Σ_obs J_ptᵀ u per point → (M, 3)."""
    return plan.pt_reduce(_grad_cols(ev.Jx, u))


def hessian_apply_cols(ev: ColsEval, plan: ColsPlan, dx_cam: jax.Array,
                       dx_pt: jax.Array):
    """J̃ᵀ(J̃·dx): (Dc,), (M, 3) — no observation gathers/scatters."""
    u = jcam_apply_cols(ev, plan, dx_cam) + jpt_apply_cols(ev, plan, dx_pt)
    return jcam_t_apply_cols(ev, plan, u), jpt_t_apply_cols(ev, plan, u)


def make_extras(problem: Problem, plan: ColsPlan) -> dict:
    """Gather-free cost/decrease/stat closures for lm's phase-fn dict.

    The flat engines' cost and pairwise-decrease passes otherwise run
    residuals.residuals_raw (4+ observation gathers each).
    ``rho_slots``/``cost_decrease_pair`` also give
    the device loop its one-pass, evaluator-consistent decrease.
    """

    def rho_slots(params):
        return rho_cols(params, problem, plan)

    def cost(params):
        return 0.5 * jnp.sum(rho_slots(params))

    def cost_decrease(p_old, p_new):
        return 0.5 * jnp.sum(rho_slots(p_old) - rho_slots(p_new))

    def cost_decrease_pair(rho_ref, cand):
        rho_new = rho_slots(cand)
        return 0.5 * jnp.sum(rho_ref - rho_new), rho_new

    def error_stats(params, thr):
        return error_stats_cols(params, problem, plan, thr)

    return {"cost": cost, "cost_decrease": cost_decrease,
            "rho_slots": rho_slots,
            "cost_decrease_pair": cost_decrease_pair,
            "error_stats": error_stats}


#: packed symmetric 3×3 index
_SYM = {(0, 0): 0, (0, 1): 1, (1, 0): 1, (0, 2): 2, (2, 0): 2,
        (1, 1): 3, (1, 2): 4, (2, 1): 4, (2, 2): 5}


def schur_jacobi_cols(ev: ColsEval, plan: ColsPlan, C_inv: jax.Array):
    """Undamped Schur-Jacobi block diagonals: (P,6,6), (K,ni,ni)."""
    ci_pack = jnp.stack(
        [C_inv[:, p, q] for (p, q) in
         [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]], axis=1)
    ci = plan.pt_broadcast(ci_pack)                  # (6, N2)
    Jx = ev.Jx

    def block(J, oh, single=False):
        w = J.shape[1]
        f = [[sum(J[r, i] * Jx[r, p] for r in range(2)) for p in range(3)]
             for i in range(w)]
        comps = []
        for i in range(w):
            for k in range(w):
                bb = sum(J[r, i] * J[r, k] for r in range(2))
                fcf = sum(f[i][p] * ci[_SYM[(p, q)]] * f[k][q]
                          for p in range(3) for q in range(3))
                comps.append(bb - fcf)
        comps = jnp.stack(comps, axis=0)
        out = (jnp.sum(comps, axis=1)[None, :] if single
               else plan.cam_reduce(oh, comps))
        return out.reshape(-1, w, w)

    D_pose = block(ev.Ja, plan.oh_a)
    if ev.Jb is not None:
        D_pose = D_pose + block(ev.Jb, plan.oh_b)
    if plan.ni > 0:
        D_intr = block(ev.Ji, plan.oh_i, single=plan.intr_single)
    else:
        D_intr = jnp.zeros((plan.n_intr, 0, 0), ev.r.dtype)
    return D_pose, D_intr
