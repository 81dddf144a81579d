"""f32-vs-f64 numerics (SURVEY.md §4.2 item 6, §7.2 hard part #1).

The accelerator runs f32 by default (f64 costs twice the bytes); the
solver must reach the f64 optimum in f32 via problem normalization +
Jacobi scaling + matmul_precision="highest".  These run
on CPU where both dtypes exist, solving the same scene in both.
"""
import jax.numpy as jnp
import numpy as np

from rsba_tpu.geometry import Loss
from rsba_tpu.problem import synthetic
from rsba_tpu.solver import SolverOptions, solve


def _scene(dtype, focal=900.0):
    return synthetic.make_ba_problem(
        n_poses=13, n_points=200, track_len=5, rolling_shutter=True,
        rotation_interp="slerp", use_distortion=True,
        loss=Loss("huber", 4.0), pixel_noise=0.5, seed=21, dtype=dtype,
        focal=focal, pad_to=32)


def test_f32_solve_matches_f64_rmse():
    opts = SolverOptions(linear_solver="banded_schur", max_iterations=40,
                         device_loop="off")
    _, s64 = solve(_scene(jnp.float64).problem, _scene(jnp.float64).params0,
                   opts)
    ba32 = _scene(jnp.float32)
    _, s32 = solve(ba32.problem, ba32.params0, opts)
    assert s64.termination == "CONVERGENCE"
    assert s32.termination == "CONVERGENCE"
    # Equal-RMSE criterion (BASELINE.json:2): f32 must land on the same
    # noise floor as f64.
    assert abs(s32.final_rmse_inlier - s64.final_rmse_inlier) < 0.02
    assert s32.final_rmse_inlier < 1.2 * ba32.pixel_noise


def test_f32_survives_long_focal_conditioning():
    """focal² enters JᵀJ — a 3000 px focal stresses f32 conditioning; the
    Jacobi-scaled solver must still reach the noise floor."""
    ba = _scene(jnp.float32, focal=3000.0)
    opts = SolverOptions(linear_solver="banded_schur", max_iterations=40,
                         device_loop="off")
    _, s = solve(ba.problem, ba.params0, opts)
    assert s.termination == "CONVERGENCE"
    assert s.final_rmse_inlier < 1.2 * ba.pixel_noise


def test_jacobi_scaling_required_in_f32_is_beneficial():
    """Sanity: with scaling disabled the f32 solve must not do better
    than the scaled one (it usually stalls earlier)."""
    ba = _scene(jnp.float32, focal=3000.0)
    opts_on = SolverOptions(linear_solver="banded_schur", max_iterations=30,
                            device_loop="off")
    opts_off = SolverOptions(linear_solver="banded_schur",
                             device_loop="off",
                             max_iterations=30, jacobi_scaling=False)
    _, s_on = solve(ba.problem, ba.params0, opts_on)
    _, s_off = solve(ba.problem, ba.params0, opts_off)
    assert s_on.final_cost <= s_off.final_cost * 1.05
