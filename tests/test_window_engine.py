"""XLA window engine vs the flat f64 dense oracle, per camera-model variant.

The banded engine (solver/window.py + solver/banded.py) is the only
evaluator of the video configs.  Each feature variant — rolling-shutter
SLERP with a Huber loss, global shutter with distortion, rolling-shutter
NLERP — must reproduce the flat evaluator's dense normal equations
(assembly) and the exact dense LM step (solve) in f64.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from rsba_tpu.problem import synthetic
from rsba_tpu.solver import assembly, banded, residuals, window
from rsba_tpu.solver.dense import make_dense_solver
from rsba_tpu.solver.options import SolverOptions

VARIANTS = {
    "rs_slerp_huber": dict(
        n_poses=9, n_points=80, track_len=3, rolling_shutter=True,
        rotation_interp="slerp", loss=synthetic.Loss("huber", 4.0),
        outlier_fraction=0.05, seed=3),
    "gs_distortion": dict(
        n_poses=9, n_points=64, track_len=3, rolling_shutter=False,
        use_distortion=True, seed=4),
    "rs_nlerp": dict(
        n_poses=9, n_points=64, track_len=3, rolling_shutter=True,
        rotation_interp="nlerp", seed=5),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def case(request):
    ba = synthetic.make_ba_problem(pixel_noise=0.5, dtype=jnp.float64,
                                   pad_to=32, **VARIANTS[request.param])
    plan = window.build_window_plan(ba.problem)
    assert plan is not None
    return ba, plan


def _dense_band(band: np.ndarray, W: int) -> np.ndarray:
    """Symmetric dense matrix from a (P, W, 6, 6) upper band."""
    P = band.shape[0]
    out = np.zeros((P * 6, P * 6))
    for p in range(P):
        for d in range(min(W, P - p)):
            out[p * 6:(p + 1) * 6, (p + d) * 6:(p + d + 1) * 6] += band[p, d]
            if d > 0:
                out[(p + d) * 6:(p + d + 1) * 6,
                    p * 6:(p + 1) * 6] += band[p, d].T
    return out


def test_window_assembly_matches_dense_oracle(case):
    """cost, g, B band, C and F == the flat evaluator's dense JᵀJ, Jᵀr."""
    ba, plan = case
    ev_w = banded.evaluate(banded.to_internal(ba.params0, plan), plan,
                           ba.problem)
    a = banded.assemble(ev_w, plan)

    ev_f = residuals.evaluate(ba.params0, ba.problem, with_jacobians=True)
    shapes = assembly.tangent_shapes(ba.problem, ba.params0)
    H, g = (np.asarray(x) for x in
            assembly.dense_normal_equations(ev_f, ba.problem, shapes))
    Dc = shapes.cam_dim
    M = shapes.n_points
    kw = dict(rtol=1e-9, atol=1e-9)

    np.testing.assert_allclose(float(ev_w.cost), float(ev_f.cost),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(a.g_cam).reshape(-1), g[:Dc], **kw)
    np.testing.assert_allclose(
        np.asarray(plan.scatter_points(a.g_pt)).reshape(-1), g[Dc:], **kw)
    np.testing.assert_allclose(_dense_band(np.asarray(a.B_band), plan.W),
                               H[:Dc, :Dc], **kw)
    C_w = np.asarray(plan.scatter_points(
        a.C.reshape(plan.NR, plan.G, 9))).reshape(M, 3, 3)
    C_f = np.stack([H[Dc + 3 * m:Dc + 3 * m + 3, Dc + 3 * m:Dc + 3 * m + 3]
                    for m in range(M)])
    np.testing.assert_allclose(C_w, C_f, **kw)

    # F[r, g, w] is the (6, 3) camera-point block of pose row_base[r] + w
    # and the point in cell (r, g); rebuild the dense E from it.
    F = np.asarray(a.F)
    row_base = np.asarray(plan.row_base)
    point_id = np.asarray(plan.point_id)
    E = np.zeros((Dc, 3 * M))
    for r in range(plan.NR):
        for gi in range(plan.G):
            m = point_id[r, gi]
            if m >= M:
                continue
            for w in range(plan.W):
                p = row_base[r] + w
                if p < shapes.n_poses:
                    E[p * 6:(p + 1) * 6, 3 * m:3 * m + 3] += F[r, gi, w]
    np.testing.assert_allclose(E, H[:Dc, Dc:], **kw)


def test_window_solve_step_matches_dense_oracle(case):
    """The banded LM step (tight PCG) == the exact dense LM step."""
    ba, plan = case
    opts = SolverOptions(max_cg_iterations=500, cg_eta=1e-12)
    fns = banded.make_window_solver_fns(ba.problem, plan, opts)
    aux_w = fns["prepare"](fns["to_internal"](ba.params0))
    prep_d, step_d = make_dense_solver(ba.problem, opts, materialize=True)
    aux_d = prep_d(ba.params0)
    np.testing.assert_allclose(float(aux_w["cost"]), float(aux_d["cost"]),
                               rtol=1e-12)
    np.testing.assert_allclose(float(aux_w["gradient_max_norm"]),
                               float(aux_d["gradient_max_norm"]), rtol=1e-9)

    radius = jnp.asarray(1e3, jnp.float64)
    dx_w, pred_w, _ = fns["solve_step"](aux_w, radius)
    dx_d, pred_d, _ = step_d(aux_d, radius)
    shapes = assembly.tangent_shapes(ba.problem, ba.params0)
    d_pose, _, d_pt = assembly.unflatten_tangent(dx_d, shapes)
    free = np.asarray(ba.problem.pose_free) > 0
    np.testing.assert_allclose(np.asarray(dx_w["pose"])[free],
                               np.asarray(d_pose)[free],
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(np.asarray(plan.scatter_points(dx_w["pt"])),
                               np.asarray(d_pt), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(float(pred_w), float(pred_d), rtol=1e-6)
