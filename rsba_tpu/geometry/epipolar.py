"""Two-view relative pose: 8-point essential matrix + cheirality bootstrap.

Parity: the reference pipeline's monocular sequence bootstrap (SURVEY.md
§3.2 — the reference leans on OpenCV ``findEssentialMat`` /
``recoverPose``; VERDICT r3 item 4's "reconstruct from scratch" requires
an in-framework equivalent).  Batched shape: the 8-point system is
solved as the smallest eigenvector of the 9×9 normal matrix ``AᵀA``
(symmetric ``eigh``, batched) rather than an (N, 9) SVD;
rays (not image points) feed the constraint so any camera convention /
distortion is absorbed by ``triangulate.backproject``.

Convention: for world-frame cameras ``X_cam = R(q)(X − c)`` with camera 1
at identity, ``d₂ᵀ E d₁ = 0`` with ``E = [t]× R``, ``R = R₂``,
``t = −R₂ c₂`` — so ``c₂ = −Rᵀ t`` with the scale gauge ``‖t‖ = 1``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import quaternion as quat
from . import triangulate
from .camera import CameraModel

_W = jnp.array([[0.0, -1.0, 0.0],
                [1.0, 0.0, 0.0],
                [0.0, 0.0, 1.0]])


def essential_from_rays(d1: jax.Array, d2: jax.Array,
                        mask: jax.Array) -> jax.Array:
    """Least-squares essential matrix from ≥8 masked ray correspondences.

    Rows of the design matrix are outer(d2, d1).reshape(9); the minimizer
    of ‖A e‖ with ‖e‖=1 is the smallest eigenvector of AᵀA.  The result
    is projected onto the essential manifold (singular values (1, 1, 0)).
    """
    rows = (d2[..., :, None] * d1[..., None, :]).reshape(
        d1.shape[:-1] + (9,))
    rows = rows * mask[..., None]
    AtA = jnp.einsum("...ni,...nj->...ij", rows, rows)
    _, vecs = jnp.linalg.eigh(AtA)          # ascending eigenvalues
    E = vecs[..., :, 0].reshape(AtA.shape[:-2] + (3, 3))
    U, _, Vt = jnp.linalg.svd(E)
    # Keep U, Vt proper rotations so the decomposition below is direct.
    U = U * jnp.sign(jnp.linalg.det(U))[..., None, None]
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))[..., None, None]
    s = jnp.array([1.0, 1.0, 0.0], E.dtype)
    return U @ (s[..., :, None] * Vt)


def decompose_essential(E: jax.Array):
    """E → the four (R, t) candidates: (Ra, ±t), (Rb, ±t), ‖t‖ = 1."""
    U, _, Vt = jnp.linalg.svd(E)
    U = U * jnp.sign(jnp.linalg.det(U))[..., None, None]
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))[..., None, None]
    W = _W.astype(E.dtype)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    return Ra, Rb, t


def two_view_init(uv1: jax.Array, uv2: jax.Array, intr: jax.Array,
                  mask: jax.Array, model: CameraModel):
    """Bootstrap a camera pair from pixel correspondences.

    Camera 1 is the identity pose; the distortion/sign conventions of
    ``model`` are honored through backprojection, but both frames are
    treated as global shutter (standard monocular RS practice: the
    bootstrap pose pair is refined by the first windowed RS BA).

    Returns (q2, c2, X, point_valid, quality): camera-2 pose (wxyz, world
    center, ‖baseline‖ = 1 gauge), midpoint-triangulated points for every
    correspondence, their validity (cheirality in both views + ray
    conditioning), and the fraction of masked correspondences that
    triangulated validly under the winning candidate.
    """
    d1 = triangulate.backproject(uv1, intr, model)
    d2 = triangulate.backproject(uv2, intr, model)
    E = essential_from_rays(d1, d2, mask)
    Ra, Rb, t = decompose_essential(E)

    def score(R, tvec):
        q2 = quat.from_matrix(R)
        c2 = -quat.rotate_inverse(q2, tvec)
        origins = jnp.stack([jnp.zeros_like(c2), c2])          # (2, 3)
        dirs = jnp.stack([d1, quat.rotate_inverse(q2, d2)], axis=-2)
        org = jnp.broadcast_to(origins, dirs.shape)
        X, valid = triangulate.triangulate_rays(org, dirs,
                                                jnp.ones(dirs.shape[:-1],
                                                         dirs.dtype))
        depth1 = jnp.sum(X * d1, axis=-1)
        depth2 = jnp.sum((X - c2) * quat.rotate_inverse(q2, d2), axis=-1)
        good = valid & (depth1 > 0) & (depth2 > 0) & (mask > 0)
        return q2, c2, X, good, jnp.sum(good)

    cands = [score(Ra, t), score(Ra, -t), score(Rb, t), score(Rb, -t)]
    counts = jnp.stack([c[4] for c in cands])
    best = jnp.argmax(counts)
    q2 = jnp.stack([c[0] for c in cands])[best]
    c2 = jnp.stack([c[1] for c in cands])[best]
    X = jnp.stack([c[2] for c in cands])[best]
    good = jnp.stack([c[3] for c in cands])[best]
    quality = counts[best] / jnp.maximum(jnp.sum(mask), 1.0)
    return q2, c2, X, good, quality
