"""Banded window solver vs the flat-layout oracle (SURVEY.md §4.2 item 3).

The window/banded engine (solver/window.py, solver/banded.py) must produce
the same costs, gradients, normal equations, steps, and converged solutions
as the flat evaluator + iterative/dense Schur solvers on the same problem.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsba_tpu.problem import synthetic
from rsba_tpu.solver import assembly, banded, lm, residuals, window
from rsba_tpu.solver.options import SolverOptions
from rsba_tpu.solver.schur import camera_gradient


@pytest.fixture(scope="module", params=["rs", "gs"])
def ba(request):
    if request.param == "rs":
        return synthetic.make_ba_problem(
            n_poses=13, n_points=160, track_len=5, rolling_shutter=True,
            rotation_interp="slerp", use_distortion=True,
            loss=synthetic.Loss("huber", 4.0), pixel_noise=0.5, seed=3,
            dtype=jnp.float64, pad_to=32, name="rs_small")
    return synthetic.make_ba_problem(
        n_poses=10, n_points=120, track_len=4, rolling_shutter=False,
        use_distortion=False, pixel_noise=0.5, seed=4, dtype=jnp.float64,
        pad_to=32, name="gs_small")


@pytest.fixture(scope="module")
def plan(ba):
    p = window.build_window_plan(ba.problem)
    assert p is not None
    return p


def test_plan_covers_all_observations(ba, plan):
    n_valid = int(jnp.sum(ba.problem.obs.mask))
    assert int(jnp.sum(plan.mask)) == n_valid
    assert int(jnp.sum(plan.point_mask)) == ba.params0.n_points


def test_window_cost_matches_flat(ba, plan):
    params_int = banded.to_internal(ba.params0, plan)
    c_w = banded.cost_only(plan, ba.problem, params_int)
    c_f = residuals.cost_only(ba.params0, ba.problem)
    np.testing.assert_allclose(float(c_w), float(c_f), rtol=1e-12)


def test_window_roundtrip_points(ba, plan):
    params_int = banded.to_internal(ba.params0, plan)
    back = banded.to_external(params_int, plan)
    np.testing.assert_array_equal(np.asarray(back.points),
                                  np.asarray(ba.params0.points))


def test_window_gradient_matches_flat(ba, plan):
    """g_cam / g_pt from the banded assembly == flat-layout gradients."""
    params_int = banded.to_internal(ba.params0, plan)
    ev_w = banded.evaluate(params_int, plan, ba.problem)
    a = banded.assemble(ev_w, plan)

    ev_f = residuals.evaluate(ba.params0, ba.problem, with_jacobians=True)
    shapes = assembly.tangent_shapes(ba.problem, ba.params0)
    g_cam_f = camera_gradient(ev_f, ba.problem, shapes)
    _, _, g_pt_f = assembly.gradient_blocks(ev_f, ba.problem, shapes)

    np.testing.assert_allclose(np.asarray(a.g_cam).reshape(-1),
                               np.asarray(g_cam_f), rtol=1e-9, atol=1e-11)
    g_pt_w = plan.scatter_points(a.g_pt)
    np.testing.assert_allclose(np.asarray(g_pt_w), np.asarray(g_pt_f),
                               rtol=1e-9, atol=1e-11)


def test_band_matches_dense_hessian(ba, plan):
    """The assembled B band + C + F reproduce the dense JᵀJ exactly."""
    params_int = banded.to_internal(ba.params0, plan)
    ev_w = banded.evaluate(params_int, plan, ba.problem)
    a = banded.assemble(ev_w, plan)

    ev_f = residuals.evaluate(ba.params0, ba.problem, with_jacobians=True)
    shapes = assembly.tangent_shapes(ba.problem, ba.params0)
    H, _ = assembly.dense_normal_equations(ev_f, ba.problem, shapes)
    P = shapes.n_poses
    Dc = shapes.cam_dim
    B_dense = np.asarray(H[:Dc, :Dc])

    B_band = np.asarray(a.B_band)
    B_rec = np.zeros_like(B_dense)
    for p in range(P):
        for d in range(plan.W):
            if p + d >= P:
                break
            blk = B_band[p, d]
            B_rec[p * 6:(p + 1) * 6, (p + d) * 6:(p + d + 1) * 6] += blk
            if d > 0:
                B_rec[(p + d) * 6:(p + d + 1) * 6,
                      p * 6:(p + 1) * 6] += blk.T
    np.testing.assert_allclose(B_rec, B_dense, rtol=1e-9, atol=1e-10)

    # Point blocks C.
    C_f = assembly.point_hessian_blocks(ev_f, ba.problem, shapes)
    C_w = plan.scatter_points(
        a.C.reshape(plan.NR, plan.G, 9)).reshape(-1, 3, 3)
    np.testing.assert_allclose(np.asarray(C_w), np.asarray(C_f),
                               rtol=1e-9, atol=1e-11)


def test_band_matvec_matches_dense(ba, plan):
    """band_matvec on the S band == dense S·x."""
    params_int = banded.to_internal(ba.params0, plan)
    ev_w = banded.evaluate(params_int, plan, ba.problem)
    a = banded.assemble(ev_w, plan)
    P = plan.n_poses
    lm_cam = jnp.full((P, 6), 0.1, jnp.float64)
    c_diag = jnp.diagonal(a.C, axis1=-2, axis2=-1)
    from rsba_tpu.solver.schur import invert_3x3_psd
    C_l = a.C + jax.vmap(jax.vmap(jnp.diag))(
        jnp.full_like(c_diag, 0.1))
    C_inv = invert_3x3_psd(C_l)
    S_band = banded.schur_band(a, plan, C_inv, lm_cam)

    # Dense reconstruction of S.
    W = plan.W
    Sb = np.asarray(S_band)
    S_dense = np.zeros((P * 6, P * 6))
    for p in range(P):
        for d in range(W):
            if p + d >= P:
                break
            S_dense[p * 6:(p + 1) * 6, (p + d) * 6:(p + d + 1) * 6] += \
                Sb[p, d]
            if d > 0:
                S_dense[(p + d) * 6:(p + d + 1) * 6,
                        p * 6:(p + 1) * 6] += Sb[p, d].T

    rng = np.random.RandomState(0)
    x = rng.randn(P, 6)
    q = banded.band_matvec(S_band, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(q).reshape(-1),
                               S_dense @ x.reshape(-1),
                               rtol=1e-9, atol=1e-9)


def test_banded_solve_step_matches_iterative_schur(ba, plan):
    """One LM solve_step: banded == flat iterative Schur (tight CG)."""
    opts = SolverOptions(linear_solver="banded_schur",
                         max_cg_iterations=500, cg_eta=1e-12)
    fns_w = banded.make_window_solver_fns(ba.problem, plan, opts)
    from rsba_tpu.solver.pcg import make_iterative_schur_solver
    prep_f, step_f = make_iterative_schur_solver(
        ba.problem, SolverOptions(linear_solver="iterative_schur",
                                  max_cg_iterations=500, cg_eta=1e-12))

    params_int = fns_w["to_internal"](ba.params0)
    aux_w = fns_w["prepare"](params_int)
    aux_f = prep_f(ba.params0)
    np.testing.assert_allclose(float(aux_w["cost"]), float(aux_f["cost"]),
                               rtol=1e-12)
    np.testing.assert_allclose(float(aux_w["gradient_max_norm"]),
                               float(aux_f["gradient_max_norm"]), rtol=1e-9)

    radius = jnp.asarray(1e4, jnp.float64)
    dx_w, pred_w, _ = fns_w["solve_step"](aux_w, radius)
    dx_f, pred_f, _ = step_f(aux_f, radius)

    shapes = assembly.tangent_shapes(ba.problem, ba.params0)
    dc_f = np.asarray(dx_f[:shapes.cam_dim]).reshape(-1, 6)
    dp_f = np.asarray(dx_f[shapes.cam_dim:]).reshape(-1, 3)
    np.testing.assert_allclose(np.asarray(dx_w["pose"]), dc_f,
                               rtol=1e-6, atol=1e-10)
    dp_w = plan.scatter_points(dx_w["pt"])
    np.testing.assert_allclose(np.asarray(dp_w), dp_f, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(float(pred_w), float(pred_f), rtol=1e-6)


def test_banded_full_solve_converges(ba, plan):
    """End-to-end LM with the banded solver reaches the noise floor and
    matches the flat solver's final RMSE."""
    opts = SolverOptions(linear_solver="banded_schur", max_iterations=30)
    params, summary = lm.solve(ba.problem, ba.params0, opts)
    assert summary.termination == "CONVERGENCE"
    assert params.points.shape == ba.params0.points.shape

    opts_f = SolverOptions(linear_solver="iterative_schur", max_iterations=30)
    _, summary_f = lm.solve(ba.problem, ba.params0, opts_f)
    assert abs(summary.final_rmse_inlier
               - summary_f.final_rmse_inlier) < 0.02
    assert summary.final_rmse_inlier < 1.2 * ba.pixel_noise


def test_cluster_jacobi_preconditioner_matches_dense_segments(ba, plan):
    """make_band_preconditioner('cluster_jacobi') == explicit dense
    segment-block solve (numpy oracle)."""
    params_int = banded.to_internal(ba.params0, plan)
    ev_w = banded.evaluate(params_int, plan, ba.problem)
    a = banded.assemble(ev_w, plan)
    from rsba_tpu.solver.schur import invert_3x3_psd
    C_inv = invert_3x3_psd(a.C + 0.1 * jnp.eye(3, dtype=jnp.float64))
    lm_cam = jnp.full((plan.n_poses, 6), 0.1, jnp.float64)
    S_band = banded.schur_band(a, plan, C_inv, lm_cam)

    K = 4
    apply = banded.make_band_preconditioner(S_band, "cluster_jacobi",
                                            segment=K)
    P = plan.n_poses
    rng = np.random.RandomState(1)
    r = rng.randn(P * 6)
    z = np.asarray(apply(jnp.asarray(r)))

    # Oracle: dense S, zero cross-segment blocks, solve per segment.
    Sb = np.asarray(S_band)
    S_dense = np.zeros((P * 6, P * 6))
    for p in range(P):
        for d in range(plan.W):
            if p + d >= P:
                break
            S_dense[p * 6:(p + 1) * 6, (p + d) * 6:(p + d + 1) * 6] += \
                Sb[p, d]
            if d > 0:
                S_dense[(p + d) * 6:(p + d + 1) * 6,
                        p * 6:(p + 1) * 6] += Sb[p, d].T
    z_ref = np.zeros_like(r)
    for s0 in range(0, P, K):
        s1 = min(s0 + K, P)
        blk = S_dense[s0 * 6:s1 * 6, s0 * 6:s1 * 6]
        z_ref[s0 * 6:s1 * 6] = np.linalg.solve(blk, r[s0 * 6:s1 * 6])
    np.testing.assert_allclose(z, z_ref, rtol=1e-8, atol=1e-10)


def test_cluster_jacobi_full_solve(ba):
    """End-to-end banded solve under the cluster preconditioner reaches
    the same optimum, in no more CG iterations than Schur-Jacobi."""
    opts_c = SolverOptions(linear_solver="banded_schur",
                           preconditioner="cluster_jacobi",
                           max_iterations=30)
    opts_j = SolverOptions(linear_solver="banded_schur",
                           preconditioner="schur_jacobi",
                           max_iterations=30)
    _, s_c = lm.solve(ba.problem, ba.params0, opts_c)
    _, s_j = lm.solve(ba.problem, ba.params0, opts_j)
    assert s_c.termination == "CONVERGENCE"
    assert abs(s_c.final_rmse_inlier - s_j.final_rmse_inlier) < 1e-3
    cg_c = sum(i.linear_solver_iterations for i in s_c.iterations)
    cg_j = sum(i.linear_solver_iterations for i in s_j.iterations)
    assert cg_c <= cg_j


def test_auto_selects_banded(ba):
    fns = lm.make_solver_fns(ba.problem, SolverOptions(linear_solver="auto"))
    assert "to_internal" in fns


def test_origin_camera_no_nan(ba, plan):
    """Padded cells gather a zero sentinel point; a gauge-fixed camera at
    the origin then projects it with Xc = 0 → 0/0.  The masked reductions
    must select (not multiply) so the NaN never reaches cost/gradients."""
    p0 = ba.params0.replace(c=ba.params0.c.at[0].set(0.0))
    params_int = banded.to_internal(p0, plan)

    c_w = banded.cost_only(plan, ba.problem, params_int)
    c_f = residuals.cost_only(p0, ba.problem)
    assert np.isfinite(float(c_w))
    np.testing.assert_allclose(float(c_w), float(c_f), rtol=1e-12)

    ev = banded.evaluate(params_int, plan, ba.problem)
    for leaf in jax.tree.leaves(ev):
        assert bool(jnp.all(jnp.isfinite(leaf))), "non-finite in evaluate"

    sq, n, sq_in, n_in = banded.error_stats(plan, ba.problem, params_int,
                                            12.0)
    assert np.isfinite(float(sq)) and np.isfinite(float(sq_in))

    dec = banded.cost_decrease(plan, ba.problem, params_int, params_int)
    np.testing.assert_allclose(float(dec), 0.0, atol=1e-12)


def test_auto_falls_back_to_flat_without_window_structure():
    """Config-2-style problems (per-camera optimizable intrinsics) do not
    admit the window layout; linear_solver='auto' must fall back to the
    flat iterative-Schur solver and still solve."""
    ba2 = synthetic.config2_gs_bal(scale=0.02, seed=1, dtype=jnp.float64)
    fns = lm.make_solver_fns(ba2.problem,
                             SolverOptions(linear_solver="auto"))
    assert fns["engine"] == ("iterative_schur", "xla-flat")
    assert "to_internal" not in fns
    _, s = lm.solve(ba2.problem, ba2.params0,
                    SolverOptions(linear_solver="auto", max_iterations=30),
                    fns=fns)
    assert s.termination == "CONVERGENCE", s.message
    assert s.linear_solver == "iterative_schur"

