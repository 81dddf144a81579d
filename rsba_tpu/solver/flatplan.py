"""Host-built observation groupings for the flat solvers.

Problem: normal-equation assembly written as duplicate-index scatter-adds
(``x.at[idx].add`` / ``segment_sum``) serializes on colliding indices.

Pattern (the same one the banded window engine uses): sort the
observation axis by the reduction key ON THE HOST at solver-build time,
pad each key's run into fixed-width rows, and the segmented reduction
becomes gather → dense ``sum`` over the slot axis → a near-unique row
fold.  The only remaining scatter has one index per ROW (unique unless a
hot key was split), not one per observation.

Cross-entity placements (camera-point block E, camera-camera cross
blocks of B) additionally use a one-hot matmul over the SECOND entity:
``einsum('rle,rl...->re...')`` instead of scattering into per-entity
columns.

Parity: replaces Ceres's per-thread block-sparse accumulation
(SURVEY.md §2 C12, §2.9 P1/P3) for the flat layout.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..problem.types import POSE_DOF, Problem


class GroupPlan(NamedTuple):
    """Observation axis grouped by one integer key.

    slots[r, l] indexes into the observation axis (value ``n_obs`` = pad
    sentinel; gathers read a zero row there).  rows[r] is the key id the
    row folds into.  ``identity_rows`` marks the common no-split case
    (rows == arange(n_segments)) where the fold is the identity.
    """
    slots: jax.Array          # (R, L) int32
    slots_t: jax.Array        # (L, R) int32 — transposed, for column form
    rows: jax.Array           # (R,) int32
    n_segments: int
    n_obs: int
    identity_rows: bool

    @property
    def R(self) -> int:
        return self.slots.shape[0]

    @property
    def L(self) -> int:
        return self.slots.shape[1]

    def gather(self, x: jax.Array) -> jax.Array:
        """(N, ...) → (R, L, ...); padded slots read zeros."""
        ext = jnp.concatenate(
            [x, jnp.zeros((1,) + x.shape[1:], x.dtype)], axis=0)
        return ext[self.slots]

    def fold_rows(self, v: jax.Array) -> jax.Array:
        """(R, ...) → (n_segments, ...): near-unique scatter-add."""
        if self.identity_rows:
            return v
        out = jnp.zeros((self.n_segments,) + v.shape[1:], v.dtype)
        return out.at[self.rows].add(v)

    def reduce(self, x: jax.Array) -> jax.Array:
        """Segmented sum of (N, ...) by the plan's key → (n_segments, ...)."""
        return self.fold_rows(jnp.sum(self.gather(x), axis=1))

    def reduce_cols(self, comps: jax.Array) -> jax.Array:
        """Segmented sum of stacked scalar components, column layout.

        comps (C, N) → (n_segments, C).  Layout note: a block-form
        reduce gathers (R, L, w, w) — two tiny minor dims; the column
        form keeps the huge axes minor throughout: gather (C, L, R), sum
        over L, one near-unique row fold.
        """
        C = comps.shape[0]
        ext = jnp.concatenate(
            [comps, jnp.zeros((C, 1), comps.dtype)], axis=1)   # (C, N+1)
        g = ext[:, self.slots_t]                               # (C, L, R)
        s = jnp.sum(g, axis=1)                                 # (C, R)
        return self.fold_rows(s.T)                             # (nseg, C)

    def gather_cols(self, comps: jax.Array) -> jax.Array:
        """comps (C, N) → slot layout (C, L, R) (sentinel zeros)."""
        C = comps.shape[0]
        ext = jnp.concatenate(
            [comps, jnp.zeros((C, 1), comps.dtype)], axis=1)
        return ext[:, self.slots_t]


def build_group_plan(ids: np.ndarray, n_segments: int,
                     max_slot: int = 512) -> GroupPlan:
    """Group the observation axis by ``ids`` (host numpy, O(N log N)).

    Rows hold up to ``max_slot`` observations of one key; keys with more
    observations get multiple rows (folded by ``fold_rows``).
    """
    ids = np.asarray(ids)
    N = int(ids.shape[0])
    order = np.argsort(ids, kind="stable")
    counts = np.bincount(ids, minlength=n_segments)
    maxc = int(counts.max()) if counts.size else 1
    L = int(min(max(maxc, 1), max_slot))
    rows_per = np.maximum(-(-counts // L), 1)       # ≥1 row per segment
    R = int(rows_per.sum())
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    row_start = np.concatenate([[0], np.cumsum(rows_per)])[:-1]
    ids_sorted = ids[order]
    within = np.arange(N) - starts[ids_sorted]
    r_idx = row_start[ids_sorted] + within // L
    c_idx = within % L
    slots = np.full((R, L), N, np.int64)
    slots[r_idx, c_idx] = order
    rows = np.repeat(np.arange(n_segments), rows_per)
    identity = bool(R == n_segments) and bool(
        np.array_equal(rows, np.arange(n_segments)))
    plan = GroupPlan(slots=jnp.asarray(slots, jnp.int32),
                     slots_t=jnp.asarray(slots.T, jnp.int32),
                     rows=jnp.asarray(rows, jnp.int32),
                     n_segments=int(n_segments), n_obs=N,
                     identity_rows=identity)
    return plan


class PairPlan(NamedTuple):
    """Observations grouped by a PAIR of keys (i, k), with the unique
    pairs' block positions for unique-index placement into a dense
    matrix: reduce → (U, wi, wk), place at (pos_i[u], pos_k[u])."""
    group: GroupPlan
    pos_i: jax.Array          # (U,) int32 — first key per unique pair
    pos_k: jax.Array          # (U,) int32


def build_pair_plan(ids_i: np.ndarray, ids_k: np.ndarray,
                    n_k: int) -> PairPlan:
    pair = np.asarray(ids_i).astype(np.int64) * n_k + np.asarray(ids_k)
    upairs, pair_idx = np.unique(pair, return_inverse=True)
    g = build_group_plan(pair_idx, len(upairs))
    return PairPlan(group=g,
                    pos_i=jnp.asarray(upairs // n_k, jnp.int32),
                    pos_k=jnp.asarray(upairs % n_k, jnp.int32))


class FlatPlans(NamedTuple):
    """All groupings the flat engines need, built once per solver."""
    pose_a: GroupPlan
    pose_b: Optional[GroupPlan]       # rolling shutter only
    intr: Optional[GroupPlan]         # ni > 0 only
    point: GroupPlan
    #: cross-pair plans for B: (pose_a, pose_b), (pose_a, intr),
    #: (pose_b, intr) — None when the entity pair does not exist
    ab: Optional[PairPlan]
    ai: Optional[PairPlan]
    bi: Optional[PairPlan]
    #: per-slot entity ids in the POINT grouping (R, L) — for the
    #: one-hot placement of E's camera columns
    pt_pose_a: jax.Array
    pt_pose_b: Optional[jax.Array]
    pt_intr: Optional[jax.Array]


def build_flat_plans(problem: Problem, ni: int) -> FlatPlans:
    """Host-side plan construction (one d2h of the index arrays)."""
    obs = problem.obs
    pa = np.asarray(obs.pose_a)
    pb = np.asarray(obs.pose_b)
    ii = np.asarray(obs.intr_idx)
    pt = np.asarray(obs.point)
    P = int(problem.pose_free.shape[0])
    K = int(problem.intr_free.shape[0])
    M = int(problem.point_free.shape[0])
    rs = problem.model.rolling_shutter
    has_intr = ni > 0

    point = build_group_plan(pt, M)

    def slot_ids(ids):
        ext = np.concatenate([ids, [0]])
        return jnp.asarray(ext[np.asarray(point.slots)], jnp.int32)

    return FlatPlans(
        pose_a=build_group_plan(pa, P),
        pose_b=build_group_plan(pb, P) if rs else None,
        intr=build_group_plan(ii, K) if has_intr else None,
        point=point,
        ab=build_pair_plan(pa, pb, P) if rs else None,
        ai=build_pair_plan(pa, ii, K) if has_intr else None,
        bi=build_pair_plan(pb, ii, K) if (rs and has_intr) else None,
        pt_pose_a=slot_ids(pa),
        pt_pose_b=slot_ids(pb) if rs else None,
        pt_intr=slot_ids(ii) if has_intr else None,
    )


# --- plan-based assembly kernels --------------------------------------------

def place_diag_blocks(B: jax.Array, blocks: jax.Array,
                      base0: int, w: int) -> jax.Array:
    """Add (P, w, w) blocks on B's diagonal at base0 + p·w (unique)."""
    P = blocks.shape[0]
    rows = base0 + jnp.arange(P)[:, None] * w + jnp.arange(w)[None, :]
    return B.at[rows[:, :, None], rows[:, None, :]].add(blocks)


def place_pair_blocks(B: jax.Array, pp: PairPlan, blocks_u: jax.Array,
                      base_i0: int, wi: int, base_k0: int,
                      wk: int) -> jax.Array:
    """Add (U, wi, wk) unique-pair blocks + their transposes into B."""
    ri = base_i0 + pp.pos_i[:, None] * wi + jnp.arange(wi)[None, :]
    ck = base_k0 + pp.pos_k[:, None] * wk + jnp.arange(wk)[None, :]
    B = B.at[ri[:, :, None], ck[:, None, :]].add(blocks_u)
    return B.at[ck[:, :, None], ri[:, None, :]].add(
        jnp.swapaxes(blocks_u, -1, -2))


#: skip the one-hot E build above this (R·L·n_e) element count — the
#: one-hot would not fit comfortably; fall back to the scatter path
ONEHOT_MAX_ELEMS = 256 * 1024 * 1024


def onehot_place(plan: GroupPlan, slot_ids: jax.Array, n_e: int,
                 blk: jax.Array) -> jax.Array:
    """Σ_slots one_hot(entity) ⊗ block → (n_segments, n_e, ...).

    blk: (N, ...) per-observation blocks; returns the per-segment,
    per-entity sums via a matmul over the slot axis (padded slots
    contribute zero because the gathered block rows are zero).
    """
    g = plan.gather(blk)                              # (R, L, ...)
    oh = jax.nn.one_hot(slot_ids, n_e, dtype=blk.dtype)   # (R, L, n_e)
    flat = g.reshape(g.shape[0], g.shape[1], -1)      # (R, L, F)
    out = jax.lax.dot_general(
        oh, flat, (((1,), (1,)), ((0,), (0,))))       # (R, n_e, F)
    out = plan.fold_rows(out)
    return out.reshape((plan.n_segments, n_e) + g.shape[2:])
