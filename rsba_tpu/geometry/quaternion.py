"""Quaternion and rotation utilities (batched, autodiff-safe).

Conventions (the single source of truth for the whole framework — see
SURVEY.md §7.2 item 4 on convention fidelity):

* Quaternions are **Hamilton**, stored ``[w, x, y, z]`` (scalar first), unit
  norm.  ``q`` represents the world→camera rotation ``R(q)``.
* Angle-axis vectors ``aa`` satisfy ``R(aa) = exp([aa]_x)`` (Rodrigues).
* All functions are pure jax, templated over dtype, and safe at the small
  angle singularities (Taylor branches chosen with ``jnp.where`` on both
  sides so forward-mode autodiff — our Jet equivalent — never sees NaN).

Reference parity: plays the role of ``ceres/rotation.h``
(``AngleAxisRotatePoint``, ``QuaternionRotatePoint``, conversions) and the
quaternion ``Manifold`` (``boxplus``) — SURVEY.md §2 C3/C18.  The reference
mount was empty this round (SURVEY.md §0), so conventions are pinned to the
standard Hamilton/Ceres ones and verified by property tests.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Small-angle threshold: below this, use Taylor branches. Generous for f32.
_EPS = 1e-8


def normalize(q: jax.Array) -> jax.Array:
    """Normalize quaternion(s) to unit norm along the last axis."""
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def multiply(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product a ⊗ b, wxyz layout, broadcasting over leading dims."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def conjugate(q: jax.Array) -> jax.Array:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector(s) v by quaternion(s) q: R(q)·v.

    Uses the two-cross-product formula (16 mul + 12 add, branch free):
    ``v' = v + 2·w·(u×v) + 2·u×(u×v)`` with ``u = q.xyz``.
    """
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def rotate_inverse(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate v by the inverse rotation: R(q)ᵀ·v."""
    return rotate(conjugate(q), v)


def to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion → 3×3 rotation matrix (row-major, R(q)·v == rotate)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(R: jax.Array) -> jax.Array:
    """Rotation matrix → unit quaternion (wxyz), batched and branch-free.

    Shepperd's method: build all four candidate quaternions (scaled by
    4w², 4x², 4y², 4z² respectively) and select the numerically largest
    pivot with a where-chain — safe for any proper rotation, including
    180° ones where the trace-based formula alone loses precision.
    Inverse of :func:`to_matrix` (property-tested).
    """
    m = R
    t0 = 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]    # 4w²
    t1 = 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2]    # 4x²
    t2 = 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2]    # 4y²
    t3 = 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]    # 4z²
    q0 = jnp.stack([t0,
                    m[..., 2, 1] - m[..., 1, 2],
                    m[..., 0, 2] - m[..., 2, 0],
                    m[..., 1, 0] - m[..., 0, 1]], axis=-1)
    q1 = jnp.stack([m[..., 2, 1] - m[..., 1, 2],
                    t1,
                    m[..., 0, 1] + m[..., 1, 0],
                    m[..., 0, 2] + m[..., 2, 0]], axis=-1)
    q2 = jnp.stack([m[..., 0, 2] - m[..., 2, 0],
                    m[..., 0, 1] + m[..., 1, 0],
                    t2,
                    m[..., 1, 2] + m[..., 2, 1]], axis=-1)
    q3 = jnp.stack([m[..., 1, 0] - m[..., 0, 1],
                    m[..., 0, 2] + m[..., 2, 0],
                    m[..., 1, 2] + m[..., 2, 1],
                    t3], axis=-1)
    ts = jnp.stack([t0, t1, t2, t3], axis=-1)
    best = jnp.argmax(ts, axis=-1)[..., None]
    q = jnp.where(best == 0, q0,
                  jnp.where(best == 1, q1,
                            jnp.where(best == 2, q2, q3)))
    return normalize(q)


def from_axis_angle(aa: jax.Array) -> jax.Array:
    """Angle-axis (3,) → unit quaternion (4,). Safe at ‖aa‖→0.

    q = [cos(θ/2), sin(θ/2)·aa/θ].
    """
    theta_sq = jnp.sum(aa * aa, axis=-1, keepdims=True)
    theta = jnp.sqrt(theta_sq + _EPS * _EPS)  # guarded; exact branch below
    half = 0.5 * theta
    small = theta_sq < _EPS
    # sin(θ/2)/θ: Taylor 0.5 - θ²/48 for small θ.
    k = jnp.where(small, 0.5 - theta_sq / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta_sq / 8.0, jnp.cos(half))
    return jnp.concatenate([w, k * aa], axis=-1)


def to_axis_angle(q: jax.Array) -> jax.Array:
    """Unit quaternion → angle-axis (3,), angle in [0, π]. Safe near identity."""
    w = q[..., :1]
    u = q[..., 1:]
    sin_half = jnp.linalg.norm(u, axis=-1, keepdims=True)
    # Map to the hemisphere w >= 0 so the angle is in [0, π].
    sign = jnp.where(w < 0, -1.0, 1.0)
    w, u, = sign * w, sign * u
    half = jnp.arctan2(sin_half, w)
    small = sin_half < _EPS
    # θ/sin(θ/2) ≈ 2 + θ²/12 … but easier: aa = u * (2·half/sin_half).
    k = jnp.where(small, 2.0, 2.0 * half / jnp.where(small, 1.0, sin_half))
    return k * u


def exp_tangent(delta: jax.Array) -> jax.Array:
    """SO(3) exponential of a tangent vector (3,) → quaternion.

    Identical to :func:`from_axis_angle`; named for the manifold role:
    ``boxplus(q, δ) = q ⊗ exp_tangent(δ)`` (right perturbation).
    """
    return from_axis_angle(delta)


def boxplus(q: jax.Array, delta: jax.Array) -> jax.Array:
    """Quaternion manifold retraction: q ⊞ δ = q ⊗ exp(δ) (right-multiplied

    local perturbation, matching Ceres's ``QuaternionManifold`` semantics of a
    3-dof tangent — SURVEY.md §2 C18).
    """
    return normalize(multiply(q, exp_tangent(delta)))


def log(q: jax.Array) -> jax.Array:
    """SO(3) logarithm: quaternion → tangent (3,) (== to_axis_angle)."""
    return to_axis_angle(q)


def relative(qa: jax.Array, qb: jax.Array) -> jax.Array:
    """qa⁻¹ ⊗ qb — the rotation taking frame a to frame b."""
    return multiply(conjugate(qa), qb)


def slerp(qa: jax.Array, qb: jax.Array, t: jax.Array) -> jax.Array:
    """Geodesic spherical interpolation between unit quaternions.

    Implemented as ``qa ⊗ exp(t·log(qa⁻¹ ⊗ qb))`` — algebraically equal to
    classic SLERP on the shortest arc, but smooth through qa == qb, which the
    sin-ratio formula is not (0/0).  Autodiff (fwd and rev) is exact.
    Shortest-arc selection is handled inside :func:`to_axis_angle` (w ≥ 0
    hemisphere).
    """
    t = jnp.asarray(t)[..., None]
    d = log(relative(qa, qb))
    return multiply(qa, exp_tangent(t * d))


def nlerp(qa: jax.Array, qb: jax.Array, t: jax.Array) -> jax.Array:
    """Normalized linear quaternion interpolation (shortest arc).

    The "linear" rolling-shutter rotation mode: component-wise lerp of the
    keyframe quaternions + renormalization, with qb sign-flipped onto qa's
    hemisphere.  Smooth and discontinuity-free for any keyframe pair
    (unlike lerping *global* axis-angle vectors, which jumps when the
    rotation angle crosses π); agrees with SLERP to O(Δθ³) for the small
    inter-frame rotations of video.
    """
    t = jnp.asarray(t)[..., None]
    dot = jnp.sum(qa * qb, axis=-1, keepdims=True)
    qb = jnp.where(dot < 0, -qb, qb)
    return normalize((1.0 - t) * qa + t * qb)


def lerp_axis_angle(aa_a: jax.Array, aa_b: jax.Array, t: jax.Array) -> jax.Array:
    """'Linear' rotation interpolation: lerp the global angle-axis vectors.

    This is the cheaper rolling-shutter interpolation mode (config 3,
    BASELINE.json:9): aa(t) = (1−t)·aa_a + t·aa_b, returned as a quaternion.
    """
    t = jnp.asarray(t)[..., None]
    return from_axis_angle((1.0 - t) * aa_a + t * aa_b)


def random_unit(key: jax.Array, shape: tuple = (), dtype=jnp.float32) -> jax.Array:
    """Uniform random unit quaternions (for tests / synthetic scenes)."""
    n = jax.random.normal(key, shape + (4,), dtype=dtype)
    return normalize(n)
