"""Subprocess body for the 2-process multi-host test (SURVEY.md §4.2
item 5): initialize the distributed runtime over localhost, build the
GLOBAL mesh spanning both processes' virtual CPU devices, run one sharded
banded LM step, and check it against the single-process solver computed
locally in this same process.

Launched by tests/test_multihost.py as:

    python tests/_multihost_runner.py PORT PROCESS_ID NUM_PROCESSES

with XLA_FLAGS=--xla_force_host_platform_device_count=4 in the env, so
the global device count is 4·NUM_PROCESSES.  Prints "MULTIHOST_OK <cost>"
on success; any assertion/runtime error exits non-zero.
"""
import sys


def main() -> int:
    port, pid, nproc = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

    import jax
    jax.config.update("jax_platforms", "cpu")
    # Cross-process CPU collectives (psum across hosts) route through
    # gloo; without it the mesh spans processes but collectives fail.
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    import numpy as np
    import jax.numpy as jnp

    from rsba_tpu import dist
    from rsba_tpu.dist.mesh import initialize_multihost
    from rsba_tpu.geometry import Loss
    from rsba_tpu.problem import synthetic
    from rsba_tpu.solver import lm
    from rsba_tpu.solver.options import SolverOptions

    info = initialize_multihost(f"localhost:{port}", nproc, pid)
    assert info["process_count"] == nproc, info
    assert info["global_devices"] == nproc * info["local_devices"], info

    mesh = dist.make_mesh()          # GLOBAL: spans both processes
    assert mesh.devices.size == info["global_devices"]

    # Identical seeded problem in every process (the multi-host contract:
    # host data is replicated; device_put shards it onto the global mesh).
    ba = synthetic.make_ba_problem(
        n_poses=9, n_points=96, track_len=4, rolling_shutter=True,
        rotation_interp="nlerp", use_distortion=False,
        loss=Loss("huber", 4.0), pixel_noise=0.3, seed=7,
        dtype=jnp.float32, pad_to=64)

    opts = SolverOptions(linear_solver="banded_schur",
                         max_cg_iterations=50, cg_eta=1e-6)
    fns_s = dist.make_sharded_window_solver_fns(ba.problem, opts, mesh)
    fns_1 = lm.make_solver_fns(ba.problem, opts)

    params_s = fns_s["to_internal"](ba.params0)
    params_1 = fns_1["to_internal"](ba.params0)
    aux_s = fns_s["prepare"](params_s)
    aux_1 = fns_1["prepare"](params_1)
    np.testing.assert_allclose(float(aux_s["cost"]), float(aux_1["cost"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux_s["gradient_max_norm"]),
                               float(aux_1["gradient_max_norm"]), rtol=1e-4)

    radius = jnp.asarray(1e4, jnp.float32)
    dx_s, pred_s, _ = fns_s["solve_step"](aux_s, radius)
    dx_1, pred_1, _ = fns_1["solve_step"](aux_1, radius)
    np.testing.assert_allclose(float(pred_s), float(pred_1), rtol=1e-2)
    np.testing.assert_allclose(np.asarray(dx_s["pose"]),
                               np.asarray(dx_1["pose"]),
                               rtol=5e-2, atol=2e-4)

    new_params, _, _ = fns_s["apply_step"](params_s, dx_s)
    new_cost = float(fns_s["cost"](new_params))
    assert new_cost < float(aux_s["cost"]), (new_cost, float(aux_s["cost"]))

    print(f"MULTIHOST_OK {new_cost:.6e} p{pid}/{nproc} "
          f"devices={info['global_devices']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
