"""Multi-view point triangulation (GS + interpolated-pose RS variant).

Parity: the reference pipeline's track triangulation step (SURVEY.md §3.2
"handler: match against map, triangulate new tracks"; VERDICT r3 item 4).
The reference delegates to OpenCV/hand-rolled DLT; here it is the midpoint
(ray least-squares) method, chosen for batching: the normal matrix
``A = Σ (I − d dᵀ)`` accumulates as batched 3×3 outer products over a
padded view axis — no per-point SVD, no dynamic shapes — and the solve is
a closed-form symmetric 3×3 inverse, identical in structure to the Schur
point blocks the solver already batches.

Rolling shutter: each observation's ray uses the pose interpolated at its
measured row time t (geometry.interpolate via camera conventions), so the
RS variant is the same code path with per-view (q, c) — SURVEY.md §2 C19.

All functions are pure jax, batched over arbitrary leading dims, masked
(padded views carry mask 0), and safe on degenerate input (returns
``valid=False`` instead of NaN).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import distortion as dist
from . import interpolate
from . import quaternion as quat
from .camera import CameraModel


def backproject(uv: jax.Array, intr: jax.Array,
                model: CameraModel) -> jax.Array:
    """Pixel → unit ray direction in the camera frame.

    Inverts the projection chain (camera.project_camera_point): pixel →
    normalized plane (intrinsics), undistort (iterative), then the ray
    ``[x, y, s]`` with ``s = projection_sign`` — so a point at positive
    depth projects back onto ``uv``.
    """
    f = intr[..., 0:2]
    pp = intr[..., 2:4]
    xy = (uv - pp) / f
    if model.use_distortion:
        xy = dist.undistort(xy, intr[..., 4:9])
    d = jnp.concatenate(
        [xy, jnp.full(xy.shape[:-1] + (1,), model.projection_sign,
                      xy.dtype)], axis=-1)
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def triangulate_rays(origins: jax.Array, dirs: jax.Array, mask: jax.Array,
                     cond_tol: float = 1e-6):
    """Midpoint triangulation of masked ray bundles.

    Minimizes Σᵢ mᵢ‖(I − dᵢdᵢᵀ)(X − oᵢ)‖² in closed form:
    ``A X = b`` with ``A = Σ m (I − ddᵀ)``, ``b = Σ m (I − ddᵀ) o``.

    Args:
      origins: (..., L, 3) ray origins (camera centers).
      dirs:    (..., L, 3) unit ray directions (world frame).
      mask:    (..., L) 1.0 valid view / 0.0 padding.
      cond_tol: conditioning gate — a bundle is valid when
        ``det(A) > cond_tol · (tr(A)/3)³`` (near-parallel rays make A
        rank-deficient; det/tr³ is a scale-free proxy for 1/condition).

    Returns:
      X: (..., 3) triangulated points (zeros where invalid).
      valid: (...,) bool — ≥2 views and well-conditioned.
    """
    m = mask[..., None, None]
    eye = jnp.eye(3, dtype=dirs.dtype)
    P = eye - dirs[..., :, None] * dirs[..., None, :]      # (..., L, 3, 3)
    A = jnp.sum(m * P, axis=-3)                            # (..., 3, 3)
    b = jnp.sum((m * P) @ origins[..., :, None], axis=-3)[..., 0]

    # Closed-form symmetric 3×3 inverse with a determinant gate.
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = a11 * a22 - a12 * a12
    co01 = a02 * a12 - a01 * a22
    co02 = a01 * a12 - a02 * a11
    det = a00 * co00 + a01 * co01 + a02 * co02
    tr3 = (a00 + a11 + a22) / 3.0
    n_views = jnp.sum(mask, axis=-1)
    valid = (n_views >= 2) & (det > cond_tol * jnp.maximum(tr3, 0.0) ** 3)

    safe_det = jnp.where(valid, det, 1.0)
    co11 = a00 * a22 - a02 * a02
    co12 = a02 * a01 - a00 * a12
    co22 = a00 * a11 - a01 * a01
    Ainv = jnp.stack([
        jnp.stack([co00, co01, co02], axis=-1),
        jnp.stack([co01, co11, co12], axis=-1),
        jnp.stack([co02, co12, co22], axis=-1)], axis=-2) / \
        safe_det[..., None, None]
    X = (Ainv @ b[..., :, None])[..., 0]
    return jnp.where(valid[..., None], X, 0.0), valid


def triangulate(qa: jax.Array, ca: jax.Array, qb: jax.Array, cb: jax.Array,
                intr: jax.Array, uv: jax.Array, t: jax.Array,
                mask: jax.Array, model: CameraModel,
                cond_tol: float = 1e-6, min_depth: float = 0.0):
    """Triangulate points from per-view observations (GS or RS).

    Args (per point, batched over leading dims; L = view axis):
      qa, ca, qb, cb: (..., L, 4/3) keyframe pose pairs per view (GS uses
        qa/ca only — pass anything for qb/cb).
      intr: (..., L, 9) intrinsics per view (broadcastable).
      uv:   (..., L, 2) measured pixels.
      t:    (..., L) shutter times (rows/H; ignored for GS).
      mask: (..., L) view validity.
      min_depth: optional cheirality gate — views whose triangulated
        point lands behind the camera (depth ≤ min_depth) invalidate the
        bundle.

    Returns (X, valid) as in :func:`triangulate_rays`, with ``valid``
    additionally requiring cheirality in every contributing view.
    """
    if model.rolling_shutter:
        q, c = interpolate.interpolate_pose(qa, ca, qb, cb, t,
                                            model.rotation_interp)
    else:
        q, c = qa, ca
    d_cam = backproject(uv, intr, model)
    d_world = quat.rotate_inverse(q, d_cam)
    X, valid = triangulate_rays(c, d_world, mask, cond_tol)

    # Cheirality: depth along each contributing ray must be positive.
    depth = jnp.sum((X[..., None, :] - c) * d_world, axis=-1)  # (..., L)
    front = jnp.where(mask > 0, depth > min_depth, True)
    return X, valid & jnp.all(front, axis=-1)


def reprojection_error(qa, ca, qb, cb, intr, uv, t, mask,
                       model: CameraModel, X: jax.Array) -> jax.Array:
    """Max masked reprojection error (px) of candidate points X — the
    acceptance gate the pipeline applies after triangulation."""
    from . import camera
    proj = camera.project(qa, ca, qb, cb, intr, X[..., None, :], t, model)
    err = jnp.linalg.norm(proj - uv, axis=-1)
    return jnp.max(jnp.where(mask > 0, err, 0.0), axis=-1)
