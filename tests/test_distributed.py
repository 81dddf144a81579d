"""Distributed-solver tests on the 8-virtual-device CPU mesh.

SURVEY.md §4.2 item 5: `shard_map` code paths are identical on CPU and
GPU; assert sharded solve == single-device solve within reduction-order
tolerance.  The repartitioned problem keeps global indices, so the exact
same padded problem is solvable both ways — a tight oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsba_tpu import dist
from rsba_tpu.problem import synthetic
from rsba_tpu.solver import lm, residuals
from rsba_tpu.solver.options import SolverOptions


def _tiny(seed=0, rolling=True):
    return synthetic.make_ba_problem(
        n_poses=9, n_points=200, track_len=4, rolling_shutter=rolling,
        rotation_interp="slerp", use_distortion=rolling, pixel_noise=0.3,
        seed=seed, dtype=jnp.float64, pad_to=32)


def test_mesh_has_8_devices():
    mesh = dist.make_mesh()
    assert mesh.devices.size == 8


def test_repartition_preserves_problem():
    """Repartitioned problem = same residuals/cost as the original."""
    ba = _tiny()
    prob2, params2, info = dist.repartition_by_point(ba.problem, ba.params0,
                                                     n_shards=8)
    c1 = float(residuals.cost_only(ba.params0, ba.problem))
    c2 = float(residuals.cost_only(params2, prob2))
    np.testing.assert_allclose(c1, c2, rtol=1e-12)
    # point restore round-trips
    pts = info.restore_points(params2.points)
    np.testing.assert_array_equal(np.asarray(pts),
                                  np.asarray(ba.params0.points))
    # each shard's observations reference only its own point chunk
    pt = np.asarray(prob2.obs.point).reshape(8, -1)
    for d in range(8):
        assert pt[d].min() >= d * info.m_local
        assert pt[d].max() < (d + 1) * info.m_local


@pytest.mark.parametrize("solver", ["iterative_schur", "dense_schur"])
def test_sharded_prepare_matches_single(solver):
    ba = _tiny(seed=1)
    prob2, params2, info = dist.repartition_by_point(ba.problem, ba.params0,
                                                     n_shards=8)
    mesh = dist.make_mesh()
    prob_s, params_s = dist.shard_ba(prob2, params2, mesh)
    opts = SolverOptions(linear_solver=solver, max_cg_iterations=300,
                         cg_eta=1e-10, refinement_steps=1)
    fns_s = dist.make_sharded_solver_fns(prob_s, opts, mesh)
    fns_1 = lm.make_solver_fns(prob2, opts)

    aux_s = fns_s["prepare"](params_s)
    aux_1 = fns_1["prepare"](params2)
    np.testing.assert_allclose(float(aux_s["cost"]), float(aux_1["cost"]),
                               rtol=1e-12)
    np.testing.assert_allclose(float(aux_s["gradient_max_norm"]),
                               float(aux_1["gradient_max_norm"]), rtol=1e-9)
    # identical damped step
    radius = jnp.asarray(1e4, jnp.float64)
    step_s, pred_s, _ = fns_s["solve_step"](aux_s, radius)
    dx_1, pred_1, _ = fns_1["solve_step"](aux_1, radius)
    np.testing.assert_allclose(float(pred_s), float(pred_1), rtol=1e-6)
    d_pose, d_intr, d_pt = step_s
    shapes = lm.assembly.tangent_shapes(prob2, params2)
    d_pose1, d_intr1, d_pt1 = lm.assembly.unflatten_tangent(
        jnp.asarray(dx_1), shapes)
    np.testing.assert_allclose(np.asarray(d_pose), np.asarray(d_pose1),
                               rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(np.asarray(d_pt), np.asarray(d_pt1),
                               rtol=1e-5, atol=1e-10)


@pytest.mark.parametrize("solver", ["iterative_schur", "dense_schur"])
def test_sharded_solve_equals_single_device(solver):
    ba = _tiny(seed=2)
    prob2, params2, info = dist.repartition_by_point(ba.problem, ba.params0,
                                                     n_shards=8)
    mesh = dist.make_mesh()
    prob_s, params_s = dist.shard_ba(prob2, params2, mesh)
    opts = SolverOptions(linear_solver=solver, max_iterations=30,
                         max_cg_iterations=200, cg_eta=1e-6,
                         device_loop="off")
    fns_s = dist.make_sharded_solver_fns(prob_s, opts, mesh)

    p_s, sum_s = lm.solve(prob_s, params_s, opts, fns=fns_s)
    p_1, sum_1 = lm.solve(prob2, params2, opts)

    assert sum_s.termination == "CONVERGENCE", sum_s.message
    assert sum_1.termination == "CONVERGENCE", sum_1.message
    np.testing.assert_allclose(sum_s.final_rmse, sum_1.final_rmse,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p_s.c), np.asarray(p_1.c),
                               rtol=1e-4, atol=1e-7)


def test_sharded_banded_matches_single_chip():
    """Banded window solver over the 8-device mesh == single-device banded
    solver: same cost/gradient, same step, same converged solution."""
    from rsba_tpu.dist.banded_sharded import make_sharded_window_solver_fns
    ba = _tiny(seed=5)
    mesh = dist.make_mesh()
    opts = SolverOptions(linear_solver="banded_schur",
                         max_cg_iterations=300, cg_eta=1e-10)
    fns_s = make_sharded_window_solver_fns(ba.problem, opts, mesh)
    fns_1 = lm.make_solver_fns(ba.problem, opts)
    assert fns_s["engine"] == ("banded_schur", "xla-window-sharded")

    p_s = fns_s["to_internal"](ba.params0)
    p_1 = fns_1["to_internal"](ba.params0)
    aux_s = fns_s["prepare"](p_s)
    aux_1 = fns_1["prepare"](p_1)
    np.testing.assert_allclose(float(aux_s["cost"]), float(aux_1["cost"]),
                               rtol=1e-12)
    np.testing.assert_allclose(float(aux_s["gradient_max_norm"]),
                               float(aux_1["gradient_max_norm"]), rtol=1e-10)

    radius = jnp.asarray(1e4, jnp.float64)
    dx_s, pred_s, _ = fns_s["solve_step"](aux_s, radius)
    dx_1, pred_1, _ = fns_1["solve_step"](aux_1, radius)
    np.testing.assert_allclose(float(pred_s), float(pred_1), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(dx_s["pose"]),
                               np.asarray(dx_1["pose"]),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(dx_s["pt"]).reshape(-1, 3),
                               np.asarray(dx_1["pt"]).reshape(-1, 3),
                               rtol=1e-6, atol=1e-12)


def test_sharded_banded_full_solve():
    """End-to-end sharded banded LM: converges and round-trips points."""
    from rsba_tpu.dist.banded_sharded import make_sharded_window_solver_fns
    ba = _tiny(seed=6)
    mesh = dist.make_mesh()
    opts = SolverOptions(linear_solver="banded_schur", max_iterations=30)
    fns_s = make_sharded_window_solver_fns(ba.problem, opts, mesh)
    p_s, sum_s = lm.solve(ba.problem, ba.params0, opts, fns=fns_s)
    assert sum_s.termination == "CONVERGENCE", sum_s.message
    assert sum_s.evaluator == "xla-window-sharded"
    assert p_s.points.shape == ba.params0.points.shape

    _, sum_1 = lm.solve(ba.problem, ba.params0, opts)
    np.testing.assert_allclose(sum_s.final_rmse, sum_1.final_rmse,
                               rtol=1e-6)


def test_sharded_global_shutter_also_works():
    ba = _tiny(seed=4, rolling=False)
    prob2, params2, _ = dist.repartition_by_point(ba.problem, ba.params0,
                                                  n_shards=8)
    mesh = dist.make_mesh()
    prob_s, params_s = dist.shard_ba(prob2, params2, mesh)
    opts = SolverOptions(linear_solver="iterative_schur", max_iterations=30)
    fns_s = dist.make_sharded_solver_fns(prob_s, opts, mesh)
    p_s, sum_s = lm.solve(prob_s, params_s, opts, fns=fns_s)
    assert sum_s.termination == "CONVERGENCE", sum_s.message
    assert sum_s.final_rmse < 1.5 * ba.pixel_noise
