"""Problem data model: parameters, observations, and the batched problem.

Parity: the reference's Thrift-generated SfM structs + ``ceres::Problem``
parameter/residual blocks (SURVEY.md §2 C1/C10), re-designed as
structure-of-arrays pytrees with static shapes — the batched layout where
every observation is one lane of a batched kernel instead of one
``ResidualBlock`` object.

Block structure (SURVEY.md §2.9 P1):

* **Pose blocks** — ``n_poses`` keyframe poses, each a unit quaternion (wxyz)
  plus camera center; tangent dim 6 (3 rotation ⊞, 3 translation).
* **Intrinsics blocks** — ``n_intr_blocks`` 9-vectors (camera.py layout);
  tangent dim ``intr_tangent_dim`` via a static basis matrix (supports
  BAL-style tied-focal [f,k1,k2] tangents, full 9-dof, or 0 = fixed).
* **Point blocks** — ``n_points`` 3-vectors (the Schur-eliminated group).

Each observation references (pose_a, pose_b, intr, point) and carries its
row-normalized shutter time t; global shutter uses pose_b == pose_a, t = 0.
Padding rows have mask = 0 and index 0 everywhere (safe gathers).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import CameraModel, Loss
from ..pytree import pytree_dataclass

#: tangent dims per pose block (3 rotation + 3 translation)
POSE_DOF = 6
#: dims per point block
POINT_DOF = 3


@pytree_dataclass
class Params:
    """Optimizable parameters as a pytree of batched arrays."""
    q: jax.Array        # (P, 4) unit quaternions, wxyz
    c: jax.Array        # (P, 3) camera centers (world)
    intr: jax.Array     # (K, 9) intrinsics vectors
    points: jax.Array   # (M, 3) world points

    @property
    def n_poses(self) -> int:
        return self.q.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def dtype(self):
        return self.points.dtype

    def astype(self, dtype) -> "Params":
        return jax.tree.map(lambda a: a.astype(dtype), self)


@pytree_dataclass
class Observations:
    """Structure-of-arrays observation table, statically padded."""
    uv: jax.Array        # (N, 2) measured pixels
    t: jax.Array         # (N,)   shutter time in [0,1] (0 for GS)
    pose_a: jax.Array    # (N,)   int32 first keyframe pose index
    pose_b: jax.Array    # (N,)   int32 second keyframe pose index (==a for GS)
    intr_idx: jax.Array  # (N,)   int32 intrinsics block index
    point: jax.Array     # (N,)   int32 point index
    mask: jax.Array      # (N,)   1.0 valid / 0.0 padding

    @property
    def n_obs(self) -> int:
        return self.uv.shape[0]


@pytree_dataclass(static=("model", "loss"))
class Problem:
    """A batched bundle-adjustment problem.

    Static (non-pytree) fields make the instance jit-stable: retracing only
    happens when the model/loss or any shape changes.
    """
    obs: Observations
    # Free/constant masks — the equivalent of Ceres SetParameterBlockConstant.
    pose_free: jax.Array    # (P,) 1.0 free / 0.0 constant
    point_free: jax.Array   # (M,) 1.0 free / 0.0 constant
    intr_free: jax.Array    # (K,) 1.0 free / 0.0 constant
    # Static (9, ni) tangent basis for intrinsics; ni == 0 → intrinsics fixed.
    intr_basis: jax.Array
    model: CameraModel
    loss: Loss

    @property
    def intr_tangent_dim(self) -> int:
        return self.intr_basis.shape[1]

    def cam_tangent_dim(self, params: Params) -> int:
        """Total camera-side tangent dimension (poses + intrinsics)."""
        return (POSE_DOF * params.n_poses
                + self.intr_tangent_dim * params.intr.shape[0])


# Common intrinsics tangent bases -------------------------------------------

def intr_basis_fixed(dtype=np.float32) -> np.ndarray:
    """Intrinsics held constant."""
    return np.zeros((9, 0), dtype=dtype)


def intr_basis_bal(dtype=np.float32) -> np.ndarray:
    """BAL-style [f, k1, k2] tangent: one focal driving fx and fy."""
    b = np.zeros((9, 3), dtype=dtype)
    b[0, 0] = b[1, 0] = 1.0   # f -> fx, fy
    b[4, 1] = 1.0             # k1
    b[5, 2] = 1.0             # k2
    return b


def intr_basis_full(dtype=np.float32) -> np.ndarray:
    """All 9 intrinsics free."""
    return np.eye(9, dtype=dtype)


def intr_basis_subset(indices, tie_focal: bool = False,
                      dtype=np.float32) -> np.ndarray:
    """Free exactly the given intrinsics indices (camera.py layout order)."""
    cols = []
    idx = list(indices)
    if tie_focal and 0 in idx:
        col = np.zeros(9, dtype=dtype)
        col[0] = col[1] = 1.0
        cols.append(col)
        idx = [i for i in idx if i not in (0, 1)]
    for i in idx:
        col = np.zeros(9, dtype=dtype)
        col[i] = 1.0
        cols.append(col)
    if not cols:
        return np.zeros((9, 0), dtype=dtype)
    return np.stack(cols, axis=1)


def make_problem(obs: Observations, n_poses: int, n_points: int, n_intr: int,
                 model: CameraModel, loss: Loss = Loss(),
                 intr_basis: Optional[np.ndarray] = None,
                 dtype=jnp.float32) -> Problem:
    """Assemble a Problem with everything free by default."""
    if intr_basis is None:
        intr_basis = intr_basis_fixed()
    problem = Problem(
        obs=obs,
        pose_free=jnp.ones((n_poses,), dtype=dtype),
        point_free=jnp.ones((n_points,), dtype=dtype),
        intr_free=jnp.ones((n_intr,), dtype=dtype),
        intr_basis=jnp.asarray(intr_basis, dtype=dtype),
        model=model,
        loss=loss,
    )
    validate_problem(problem)
    return problem


def validate_problem(problem: Problem) -> None:
    """Structural sanity checks — the equivalent of Ceres's debug-mode
    problem validation / sanitizer builds (SURVEY.md §5.2): shape and
    dtype consistency, index ranges, and finite observation data.

    Raises ValueError on the first violation.  Host-side (uses concrete
    values); call at construction/load time, not inside jit.
    """
    obs = problem.obs
    N = obs.n_obs
    for name in ("t", "pose_a", "pose_b", "intr_idx", "point", "mask"):
        a = getattr(obs, name)
        if a.shape[0] != N:
            raise ValueError(f"obs.{name} has {a.shape[0]} rows, uv has {N}")
    if obs.uv.shape != (N, 2):
        raise ValueError(f"obs.uv must be (N, 2), got {obs.uv.shape}")
    P = problem.pose_free.shape[0]
    M = problem.point_free.shape[0]
    K = problem.intr_free.shape[0]
    valid = np.asarray(obs.mask) > 0
    for name, hi in (("pose_a", P), ("pose_b", P), ("intr_idx", K),
                     ("point", M)):
        idx = np.asarray(getattr(obs, name))[valid]
        if idx.size and (idx.min() < 0 or idx.max() >= hi):
            raise ValueError(
                f"obs.{name} out of range [0, {hi}): "
                f"[{idx.min()}, {idx.max()}]")
    if problem.intr_basis.shape[0] != 9:
        raise ValueError(
            f"intr_basis must be (9, ni), got {problem.intr_basis.shape}")
    uv = np.asarray(obs.uv)[valid]
    t = np.asarray(obs.t)[valid]
    if uv.size and not np.isfinite(uv).all():
        raise ValueError("non-finite pixel coordinates in valid obs")
    if t.size and (t.min() < 0.0 or t.max() > 1.0):
        raise ValueError(f"shutter time t outside [0, 1]: "
                         f"[{t.min()}, {t.max()}]")
    if problem.model.rolling_shutter:
        pa = np.asarray(obs.pose_a)[valid]
        pb = np.asarray(obs.pose_b)[valid]
        if pa.size and (pb < pa).any():
            raise ValueError("rolling shutter requires pose_b >= pose_a")
