"""P3P minimal solver (Grunert) — batched, closed form.

Parity: the reference's minimal-solver path for new-frame registration
(SURVEY.md §2 C19; VERDICT r3 item 5).  The classical Grunert (1841)
reduction — public-domain geometry, standard in every multiple-view text:
three unit rays fᵢ and three world points Xᵢ give a quartic in the depth
ratio; each admissible root yields camera-frame points sᵢfᵢ, and a rigid
alignment (Kabsch) recovers the pose.

Batched shape: everything is batched over the hypothesis axis — the
quartic is solved in closed form (Ferrari, complex arithmetic; no
iteration, no data-dependent control flow) and the alignment is a batched
3×3 SVD, so a RANSAC loop evaluates hundreds of hypotheses as ONE
dispatch (solver/ransac.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import quaternion as quat


# --- closed-form polynomial roots (batched, complex) -------------------------

def _complex_dtype(dtype):
    return jnp.complex128 if dtype == jnp.float64 else jnp.complex64


def solve_cubic_roots(B, C, D):
    """All three complex roots of m³ + B m² + C m + D (batched, Cardano)."""
    cdt = _complex_dtype(B.dtype)
    B, C, D = (x.astype(cdt) for x in (B, C, D))
    p = C - B * B / 3.0
    q = 2.0 * B ** 3 / 27.0 - B * C / 3.0 + D
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    sq = jnp.sqrt(disc)
    u3 = -q / 2.0 + sq
    # Avoid the u == 0 branch (p == 0, q >= 0) by switching the sqrt sign
    # where it gives the larger magnitude.
    u3b = -q / 2.0 - sq
    u3 = jnp.where(jnp.abs(u3) >= jnp.abs(u3b), u3, u3b)
    u = u3 ** (1.0 / 3.0)
    u = jnp.where(jnp.abs(u) < 1e-30, 1e-30, u)
    v = -p / (3.0 * u)
    w = jnp.asarray(-0.5 + 0.8660254037844386j, cdt)   # exp(2πi/3)
    roots = [u * w ** k + v * jnp.conj(w) ** k - B / 3.0 for k in range(3)]
    return jnp.stack(roots, axis=-1)


def solve_quartic_roots(c4, c3, c2, c1, c0):
    """All four complex roots of c4 z⁴ + … + c0 (batched, Ferrari).

    Degenerate leading coefficients (|c4| ≈ 0) return NaN roots — the
    caller's realness/positivity gates discard them.
    """
    dtype = c4.dtype
    cdt = _complex_dtype(dtype)
    scale = jnp.maximum(jnp.max(
        jnp.stack([jnp.abs(c) for c in (c4, c3, c2, c1, c0)], axis=-1),
        axis=-1), 1e-30)
    bad = jnp.abs(c4) < 1e-10 * scale
    c4s = jnp.where(bad, 1.0, c4)
    b, c, d, e = (x / c4s for x in (c3, c2, c1, c0))
    # Depressed quartic z = y − b/4:  y⁴ + p y² + q y + r
    p = c - 3.0 * b * b / 8.0
    q = d - b * c / 2.0 + b ** 3 / 8.0
    r = e - b * d / 4.0 + b * b * c / 16.0 - 3.0 * b ** 4 / 256.0
    # Resolvent cubic 8m³ + 8pm² + (2p² − 8r)m − q² = 0.
    m_roots = solve_cubic_roots(
        jnp.asarray(p, dtype), (2.0 * p * p - 8.0 * r) / 8.0,
        -q * q / 8.0)
    alpha2 = 2.0 * m_roots                               # α² candidates
    # Pick the root giving the largest |α| (keeps q/α well-conditioned;
    # handles biquadratics where one resolvent root is exactly 0).
    pick = jnp.argmax(jnp.abs(alpha2), axis=-1)[..., None]
    alpha2 = jnp.take_along_axis(alpha2, pick, axis=-1)[..., 0]
    alpha = jnp.sqrt(alpha2.astype(cdt))
    alpha = jnp.where(jnp.abs(alpha) < 1e-30, 1e-30, alpha)
    pc = p.astype(cdt)
    qc = q.astype(cdt)
    beta = (pc + alpha * alpha - qc / alpha) / 2.0
    gamma = (pc + alpha * alpha + qc / alpha) / 2.0
    # (y² + αy + β)(y² − αy + γ) = 0
    s1 = jnp.sqrt(alpha * alpha - 4.0 * beta)
    s2 = jnp.sqrt(alpha * alpha - 4.0 * gamma)
    roots = jnp.stack([(-alpha + s1) / 2.0, (-alpha - s1) / 2.0,
                       (alpha + s2) / 2.0, (alpha - s2) / 2.0], axis=-1)
    roots = roots - (b / 4.0).astype(cdt)[..., None]
    nan = jnp.asarray(jnp.nan + 0j, cdt)
    return jnp.where(bad[..., None], nan, roots)


def _polish_roots(c4, c3, c2, c1, c0, roots, iters: int = 2):
    """Newton-polish complex roots (cheap insurance for f32)."""
    for _ in range(iters):
        cs = [x.astype(roots.dtype)[..., None] for x in (c4, c3, c2, c1, c0)]
        f = (((cs[0] * roots + cs[1]) * roots + cs[2]) * roots
             + cs[3]) * roots + cs[4]
        df = ((4.0 * cs[0] * roots + 3.0 * cs[1]) * roots
              + 2.0 * cs[2]) * roots + cs[3]
        df = jnp.where(jnp.abs(df) < 1e-30, 1e-30, df)
        roots = roots - f / df
    return roots


# --- Grunert P3P --------------------------------------------------------------

def _polymul(a, b):
    """Multiply coefficient lists (ascending powers of y) of jax scalars."""
    out = [0.0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] = out[i + j] + ai * bj
    return out


def p3p(rays: jax.Array, points: jax.Array):
    """Grunert P3P: camera pose(s) from 3 ray/point correspondences.

    Args:
      rays:   (..., 3, 3) unit bearing vectors in the camera frame.
      points: (..., 3, 3) corresponding world points.

    Returns:
      q: (..., 4, 4) up to four world→camera quaternions (wxyz),
      c: (..., 4, 3) camera centers (world),
      valid: (..., 4) admissibility of each solution (real positive
        depths, non-degenerate geometry).

    Convention matches geometry.camera: ``X_cam = R(q)(X − c)`` — the
    recovered pose satisfies ``sᵢ · rayᵢ = R(q)(Xᵢ − c)``.
    """
    f1, f2, f3 = rays[..., 0, :], rays[..., 1, :], rays[..., 2, :]
    X1, X2, X3 = points[..., 0, :], points[..., 1, :], points[..., 2, :]
    dtype = rays.dtype

    a2 = jnp.sum((X2 - X3) ** 2, axis=-1)
    b2 = jnp.sum((X1 - X3) ** 2, axis=-1)
    c2 = jnp.sum((X1 - X2) ** 2, axis=-1)
    p = 2.0 * jnp.sum(f2 * f3, axis=-1)
    qq = 2.0 * jnp.sum(f1 * f3, axis=-1)
    r = 2.0 * jnp.sum(f1 * f2, axis=-1)

    b2s = jnp.where(b2 > 1e-30, b2, 1.0)
    A = a2 / b2s
    B = c2 / b2s
    # x = s2/s1 = N(y)/D(y); quartic Q(y) = D²(1 − B·M) + N² − r·N·D.
    N = [1.0 + (A - B), -(A - B) * qq, (A - B) - 1.0]
    D = [r, -p]
    M = [jnp.ones_like(A), -qq, jnp.ones_like(A)]
    D2 = _polymul(D, D)
    one_minus_BM = [1.0 - B * M[0], -B * M[1], -B * M[2]]
    Q = [jnp.zeros_like(A)] * 5
    for i, v in enumerate(_polymul(D2, one_minus_BM)):
        Q[i] = Q[i] + v
    for i, v in enumerate(_polymul(N, N)):
        Q[i] = Q[i] + v
    for i, v in enumerate(_polymul([-r * n for n in N], D)):
        Q[i] = Q[i] + v

    roots = solve_quartic_roots(Q[4], Q[3], Q[2], Q[1], Q[0])
    roots = _polish_roots(Q[4], Q[3], Q[2], Q[1], Q[0], roots)
    y = jnp.real(roots)                                    # (..., 4)
    im = jnp.abs(jnp.imag(roots))
    real_ok = im <= 1e-4 * (1.0 + jnp.abs(y))

    # Depths from each real root.
    Ny = (N[0][..., None] + N[1][..., None] * y + N[2][..., None] * y * y)
    Dy = D[0][..., None] + D[1][..., None] * y
    Dy = jnp.where(jnp.abs(Dy) < 1e-12, 1e-12, Dy)
    x = Ny / Dy
    My = (M[0][..., None] + M[1][..., None] * y + M[2][..., None] * y * y)
    s1 = jnp.sqrt(b2[..., None] / jnp.where(My > 1e-12, My, 1.0))
    s2 = x * s1
    s3 = y * s1
    valid = (real_ok & (My > 1e-12) & (y > 0) & (x > 0)
             & jnp.isfinite(y) & (b2[..., None] > 1e-30))

    # Camera-frame points Yᵢ = sᵢ fᵢ → rigid alignment (Kabsch) world→cam.
    Y = jnp.stack([s1[..., None] * f1[..., None, :],
                   s2[..., None] * f2[..., None, :],
                   s3[..., None] * f3[..., None, :]], axis=-2)
    Xw = jnp.broadcast_to(points[..., None, :, :], Y.shape)
    Xbar = jnp.mean(Xw, axis=-2, keepdims=True)
    Ybar = jnp.mean(Y, axis=-2, keepdims=True)
    H = jnp.einsum("...ki,...kj->...ij", Xw - Xbar, Y - Ybar)
    U, _, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(jnp.swapaxes(Vt, -1, -2) @
                         jnp.swapaxes(U, -1, -2))
    S = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    R = (jnp.swapaxes(Vt, -1, -2) * S[..., None, :]) @ \
        jnp.swapaxes(U, -1, -2)
    q = quat.from_matrix(R)
    # Y = R X + t → c = −Rᵀ t = Xbar − Rᵀ Ybar.
    cpos = Xbar[..., 0, :] - quat.rotate_inverse(q, Ybar[..., 0, :])
    valid = valid & jnp.all(jnp.isfinite(q), axis=-1) \
        & jnp.all(jnp.isfinite(cpos), axis=-1)
    q = jnp.where(valid[..., None],
                  jnp.where(jnp.isfinite(q), q, 0.0),
                  jnp.broadcast_to(
                      jnp.asarray([1.0, 0, 0, 0], dtype), q.shape))
    cpos = jnp.where(valid[..., None],
                     jnp.where(jnp.isfinite(cpos), cpos, 0.0), 0.0)
    return q, cpos, valid
