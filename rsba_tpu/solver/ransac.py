"""Robust frame registration: P3P + RANSAC in one batched dispatch.

Parity: the reference's RANSAC-PnP registration of a new frame from raw
2D-3D matches with outliers and no prior pose (SURVEY.md §2 C19, §3.2;
VERDICT r3 item 5).  Batched shape: instead of the reference's
sequential hypothesize-and-verify loop, ALL hypotheses run at once —
K sampled triples → batched Grunert P3P (solver/p3p.py, ≤4K candidate
poses) → one batched projection of every candidate against every match
(a matmul-shaped (4K, M) scoring pass) → argmax inliers — then one robust
pose-only LM polish on the winner's inliers (solver/pnp.py).

Rolling shutter: hypotheses are scored under the global-shutter model
(the intra-frame warp is a few pixels — absorbed by the inlier
threshold); the final polish runs the full RS model when ``rows`` and
``image_height`` are given.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import CameraModel, Loss, camera, triangulate
from .options import SolverOptions
from . import p3p as p3p_mod
from . import pnp


def ransac_pnp(
    points3d,
    uv,
    intr,
    model: CameraModel,
    *,
    rows=None,
    image_height: Optional[int] = None,
    n_hypotheses: int = 256,
    inlier_threshold: float = 8.0,
    min_inliers: int = 6,
    seed: int = 0,
    refine: bool = True,
    loss: Loss = Loss("huber", 4.0),
    options: Optional[SolverOptions] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray,
           np.ndarray, dict]:
    """Register a frame from 2D-3D matches — no prior pose, outliers OK.

    Args:
      points3d: (M, 3) map points.
      uv: (M, 2) measured pixels.
      intr: (9,) intrinsics.
      model: camera model (scoring always GS; RS used for the polish).
      rows / image_height: RS shutter rows (required for an RS polish).
      n_hypotheses: sampled minimal triples (all solved in one dispatch).
      inlier_threshold: reprojection gate in pixels.
      min_inliers: fail below this support.
      refine: run the robust pose-only LM polish on the inliers.

    Returns (q_a, c_a, q_b, c_b, inlier_mask, info) — info carries
    ``num_inliers``, ``num_hypotheses``, ``best_inliers_prepolish`` and
    the polish Summary (or None).  Raises ValueError when no hypothesis
    reaches ``min_inliers``.
    """
    points3d = np.asarray(points3d)
    uv_np = np.asarray(uv)
    M = points3d.shape[0]
    if M < 3:
        raise ValueError(f"need >= 3 matches, got {M}")
    dtype = jnp.asarray(points3d).dtype

    rng = np.random.RandomState(seed)
    idx = rng.randint(0, M, size=(n_hypotheses, 3))
    # Reject duplicate indices inside a triple (degenerate P3P) by
    # resampling once; residual duplicates simply produce invalid
    # hypotheses, which the valid mask discards.
    dup = ((idx[:, 0] == idx[:, 1]) | (idx[:, 0] == idx[:, 2])
           | (idx[:, 1] == idx[:, 2]))
    idx[dup] = rng.randint(0, M, size=(int(dup.sum()), 3))

    gs = CameraModel(rolling_shutter=False,
                     use_distortion=model.use_distortion,
                     projection_sign=model.projection_sign)
    intr_j = jnp.asarray(intr, dtype)
    pts_j = jnp.asarray(points3d, dtype)
    uv_j = jnp.asarray(uv_np, dtype)

    rays = triangulate.backproject(uv_j[jnp.asarray(idx)], intr_j, gs)
    q_cand, c_cand, valid = p3p_mod.p3p(rays, pts_j[jnp.asarray(idx)])
    q_flat = q_cand.reshape(-1, 4)                     # (4K, 4)
    c_flat = c_cand.reshape(-1, 3)
    v_flat = valid.reshape(-1)

    # Score every candidate against every match (GS projection).
    proj = camera.project_global(q_flat[:, None, :], c_flat[:, None, :],
                                 intr_j, pts_j[None, :, :], gs)
    err2 = jnp.sum((proj - uv_j[None, :, :]) ** 2, axis=-1)   # (4K, M)
    depth = camera.depth_in_camera(
        q_flat[:, None, :], c_flat[:, None, :], q_flat[:, None, :],
        c_flat[:, None, :], pts_j[None, :, :],
        jnp.zeros_like(err2), gs)
    inl = (err2 <= inlier_threshold ** 2) & (depth > 0)
    counts = jnp.where(v_flat, jnp.sum(inl, axis=-1), -1)
    best = int(jnp.argmax(counts))
    n_best = int(counts[best])
    if n_best < min_inliers:
        raise ValueError(
            f"RANSAC failed: best hypothesis has {max(n_best, 0)} inliers "
            f"(< {min_inliers}) over {n_hypotheses} samples")
    inlier_mask = np.asarray(inl[best])
    q_best, c_best = q_flat[best], c_flat[best]

    info = {"num_hypotheses": n_hypotheses,
            "best_inliers_prepolish": n_best, "summary": None}
    if not refine:
        info["num_inliers"] = n_best
        return q_best, c_best, q_best, c_best, inlier_mask, info

    sel = np.nonzero(inlier_mask)[0]
    rows_sel = (np.asarray(rows)[sel] if rows is not None
                else np.zeros(sel.shape[0]))
    q_a, c_a, q_b, c_b, summary = pnp.register_frame(
        points3d[sel], uv_np[sel], rows_sel, np.asarray(intr), model,
        np.asarray(q_best), np.asarray(c_best),
        image_height=image_height, loss=loss, options=options,
        dtype=dtype)
    # Final inlier set under the polished pose.
    t_all = (jnp.asarray(np.clip(np.asarray(rows), 0, image_height)
                         / float(image_height), dtype)
             if (model.rolling_shutter and rows is not None) else
             jnp.zeros((M,), dtype))
    proj2 = camera.project(q_a, c_a, q_b, c_b, intr_j, pts_j, t_all, model)
    err2f = jnp.sum((proj2 - uv_j) ** 2, axis=-1)
    # Same gate as hypothesis scoring: reprojection AND cheirality — a
    # point behind the camera whose (distorted) projection lands near uv
    # must not count as an inlier (ADVICE r4).
    depth_f = camera.depth_in_camera(q_a, c_a, q_b, c_b, pts_j, t_all,
                                     model)
    inlier_mask = np.asarray((err2f <= inlier_threshold ** 2)
                             & (depth_f > 0))
    info["num_inliers"] = int(inlier_mask.sum())
    info["summary"] = summary
    return q_a, c_a, q_b, c_b, inlier_mask, info
