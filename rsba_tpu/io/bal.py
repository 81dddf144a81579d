"""Bundle Adjustment in the Large (BAL) problem file I/O.

Parity: SURVEY.md §2 C22 — the standard BAL text format
(https://grail.cs.washington.edu/projects/bal/):

    <n_cams> <n_points> <n_obs>
    <cam_idx> <pt_idx> <u> <v>          × n_obs
    <9 camera params: aa(3) t(3) f k1 k2>  × n_cams (one value per line)
    <3 point coords>                        × n_points

BAL camera convention: X_cam = R(aa)·X + t, camera looks down −z
(p = −X_cam.xy/X_cam.z), radial-only distortion 1 + k1 r² + k2 r⁴, pixels
centered at the principal point.  Converted here into the framework
convention (q, c = −Rᵀt, projection_sign = −1, intrinsics
[f, f, 0, 0, k1, k2, 0, 0, 0]).
"""
from __future__ import annotations

import gzip
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..geometry import CameraModel, Loss
from ..geometry import quaternion as quat
from ..problem.types import (Observations, Params, Problem, intr_basis_bal,
                             intr_basis_fixed, make_problem)

BAL_CAMERA_MODEL = CameraModel(rolling_shutter=False, use_distortion=True,
                               projection_sign=-1.0)


def _open(path: str, mode: str = "rt"):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(path, mode)
    if p.endswith(".bz2"):
        import bz2
        return bz2.open(path, mode)
    return open(path, mode)


def load_bal(path: str, *, loss: Loss = Loss("huber", 4.0),
             optimize_intrinsics: bool = True, dtype=jnp.float64,
             pad_to: int = 1024, fix_gauge: bool = True):
    """Load a BAL problem file → (Problem, Params).

    Returns the problem in framework convention with per-camera intrinsics
    blocks; the solver's initial parameters are the file's parameters.
    """
    with _open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    n_cams, n_pts, n_obs = int(next(it)), int(next(it)), int(next(it))

    cam_idx = np.empty(n_obs, np.int32)
    pt_idx = np.empty(n_obs, np.int32)
    uv = np.empty((n_obs, 2), np.float64)
    for i in range(n_obs):
        cam_idx[i] = int(next(it))
        pt_idx[i] = int(next(it))
        uv[i, 0] = float(next(it))
        uv[i, 1] = float(next(it))

    cam_params = np.array([float(next(it)) for _ in range(9 * n_cams)]
                          ).reshape(n_cams, 9)
    points = np.array([float(next(it)) for _ in range(3 * n_pts)]
                      ).reshape(n_pts, 3)

    aa = cam_params[:, 0:3]
    t = cam_params[:, 3:6]
    q = np.asarray(quat.from_axis_angle(jnp.asarray(aa)))
    # c = −Rᵀ t  (our pose stores the camera center)
    c = -np.asarray(quat.rotate_inverse(jnp.asarray(q), jnp.asarray(t)))
    intr = np.zeros((n_cams, 9))
    intr[:, 0] = intr[:, 1] = cam_params[:, 6]   # f
    intr[:, 4] = cam_params[:, 7]                # k1
    intr[:, 5] = cam_params[:, 8]                # k2

    params = Params(q=jnp.asarray(q, dtype), c=jnp.asarray(c, dtype),
                    intr=jnp.asarray(intr, dtype),
                    points=jnp.asarray(points, dtype))

    n_pad = -n_obs % pad_to
    total = n_obs + n_pad

    def pad(a, np_dtype):
        out = np.zeros((total,) + a.shape[1:], dtype=np_dtype)
        out[:n_obs] = a
        return out

    np_dtype = np.dtype(jnp.zeros((), dtype).dtype)
    obs_np = Observations(
        uv=pad(uv, np_dtype),
        t=np.zeros((total,), np_dtype),
        pose_a=pad(cam_idx, np.int32),
        pose_b=pad(cam_idx, np.int32),
        intr_idx=pad(cam_idx, np.int32),
        point=pad(pt_idx, np.int32),
        mask=pad(np.ones(n_obs), np_dtype),
    )
    import jax
    obs = jax.tree.map(jnp.asarray, obs_np)

    basis = (intr_basis_bal(np_dtype) if optimize_intrinsics
             else intr_basis_fixed(np_dtype))
    problem = make_problem(obs, n_cams, n_pts, n_cams, BAL_CAMERA_MODEL,
                           loss, intr_basis=basis, dtype=dtype)
    if fix_gauge:
        problem = problem.replace(pose_free=problem.pose_free.at[0].set(0.0))
    return problem, params


def save_bal(path: str, problem: Problem, params: Params) -> None:
    """Write (problem, params) back to BAL text format (inverse of load).

    Refuses problems that BAL's 9-parameter camera cannot represent
    (non-BAL projection convention, principal point, tangential/k3
    distortion, fx≠fy) rather than silently dropping information.
    """
    if problem.model != BAL_CAMERA_MODEL:
        raise ValueError(
            "save_bal requires the BAL camera convention "
            f"({BAL_CAMERA_MODEL}), got {problem.model}")
    intr_np = np.asarray(params.intr)
    lossy = (np.abs(intr_np[:, 2:4]).max() > 0          # cx, cy
             or np.abs(intr_np[:, 6:9]).max() > 0       # p1, p2, k3
             or np.abs(intr_np[:, 0] - intr_np[:, 1]).max() > 0)  # fx≠fy
    if lossy:
        raise ValueError("BAL format cannot represent principal point, "
                         "tangential/k3 distortion, or fx≠fy")
    obs = problem.obs
    mask = np.asarray(obs.mask) > 0
    cam_idx = np.asarray(obs.pose_a)[mask]
    pt_idx = np.asarray(obs.point)[mask]
    uv = np.asarray(obs.uv)[mask]
    q = params.q
    aa = np.asarray(quat.to_axis_angle(q))
    t = -np.asarray(quat.rotate(q, params.c))
    intr = np.asarray(params.intr)
    pts = np.asarray(params.points)
    with _open(path, "wt") as f:
        f.write(f"{q.shape[0]} {pts.shape[0]} {mask.sum()}\n")
        for i in range(mask.sum()):
            f.write(f"{cam_idx[i]} {pt_idx[i]} {uv[i, 0]:.12g} "
                    f"{uv[i, 1]:.12g}\n")
        for k in range(q.shape[0]):
            vals = list(aa[k]) + list(t[k]) + [intr[k, 0], intr[k, 4],
                                               intr[k, 5]]
            f.write("\n".join(f"{v:.16e}" for v in vals) + "\n")
        for p in pts:
            f.write("\n".join(f"{v:.16e}" for v in p) + "\n")


def export_ply(path: str, params: Params,
               point_color=(200, 200, 200), cam_color=(255, 64, 64)) -> None:
    """Export the reconstruction (points + camera centers) as a PLY cloud.

    Parity: the reference's PLY export utility (SURVEY.md §2 C22).
    """
    pts = np.asarray(params.points)
    cams = np.asarray(params.c)
    n = pts.shape[0] + cams.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p in pts:
            f.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g} "
                    f"{point_color[0]} {point_color[1]} {point_color[2]}\n")
        for c in cams:
            f.write(f"{c[0]:.6g} {c[1]:.6g} {c[2]:.6g} "
                    f"{cam_color[0]} {cam_color[1]} {cam_color[2]}\n")
