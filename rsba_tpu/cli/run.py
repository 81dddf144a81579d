"""CLI problem runner — the framework's service frontend.

Parity: the reference's Thrift service + tools (SURVEY.md §2 C20, L6)
re-scoped as a CLI over the five judged config presets and BAL files:

    python -m rsba_tpu.cli.run --config=rs_slerp_robust --scale=0.1
    python -m rsba_tpu.cli.run --bal=problem.txt --linear-solver=dense_schur
    python -m rsba_tpu.cli.run --config=rs_mhost_pcg --shard --verbose

Per-config solver defaults mirror BASELINE.json:7-11 (dense for config 1,
Schur for 2-4, sharded PCG for 5).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


CONFIG_SOLVER_DEFAULTS = {
    "gs_small": "dense",
    "gs_bal": "dense_schur",
    # Video configs: "auto" resolves to the banded window solver.
    "rs_video_linear": "auto",
    "rs_slerp_robust": "auto",
    "rs_mhost_pcg": "auto",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rsba_tpu.cli.run",
        description="rolling-shutter bundle adjustment runner")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--config", choices=sorted(CONFIG_SOLVER_DEFAULTS),
                     help="synthetic judged-config preset")
    src.add_argument("--bal", metavar="FILE",
                     help="BAL-format problem file (text, .gz or .bz2)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="size multiplier for synthetic configs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", choices=["f32", "f64"], default=None,
                   help="default: f32 on an accelerator, f64 on CPU")
    p.add_argument("--linear-solver",
                   choices=["auto", "dense", "dense_schur",
                            "iterative_schur", "banded_schur"],
                   default=None, help="default: per-config preset")
    p.add_argument("--preconditioner",
                   choices=["jacobi", "schur_jacobi", "cluster_jacobi"],
                   default="schur_jacobi",
                   help="PCG preconditioner; cluster_jacobi = "
                        "visibility-clustered blocks (trajectory segments "
                        "on the banded path, co-visibility camera "
                        "clusters on the flat iterative_schur path)")
    p.add_argument("--trust-region-strategy", choices=["lm", "dogleg"],
                   default="lm",
                   help="dogleg (Ceres TRADITIONAL_DOGLEG) requires an "
                        "exact step solver: dense or dense_schur")
    p.add_argument("--check-gradients", action="store_true",
                   help="verify autodiff Jacobians against finite "
                        "differences before solving (Ceres "
                        "check_gradients); raises on mismatch")
    p.add_argument("--max-iterations", type=int, default=50)
    p.add_argument("--max-cg-iterations", type=int, default=100)
    p.add_argument("--cg-eta", type=float, default=1e-2)
    p.add_argument("--function-tolerance", type=float, default=1e-6)
    p.add_argument("--shard", action="store_true",
                   help="run the sharded solver over all devices")
    p.add_argument("--multihost", action="store_true",
                   help="call jax.distributed.initialize() before mesh "
                        "construction so --shard spans every process; run "
                        "the same command in each process (under SLURM or "
                        "Open MPI the cluster is auto-detected)")
    p.add_argument("--coordinator", default=None,
                   help="coordinator HOST:PORT for --multihost outside "
                        "SLURM / Open MPI (default: auto-detect)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count for --multihost (default: auto)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index for --multihost "
                        "(default: auto)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="persist solver state each accepted step (orbax)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--profile-dir", default=None,
                   help="capture an xprof/TensorBoard trace of the solve "
                        "into this directory (jax.profiler.trace; phases "
                        "carry named_scope annotations)")
    p.add_argument("--jsonl", default=None,
                   help="write per-iteration JSONL records here")
    p.add_argument("--ply", default=None,
                   help="export the optimized point cloud as PLY")
    p.add_argument("--debug-nans", action="store_true",
                   help="sanitizer mode: jax_debug_nans raises at the "
                        "first NaN-producing op (SURVEY.md §5.2)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--full-report", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from ..utils.compilation import compile_clock, enable_compile_cache
    enable_compile_cache()
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    if args.multihost:
        from ..dist import initialize_multihost
        info_mh = initialize_multihost(args.coordinator,
                                       args.num_processes, args.process_id)
        print(f"[rsba_tpu] multihost: process "
              f"{info_mh['process_id']}/{info_mh['process_count']}, "
              f"{info_mh['local_devices']} local / "
              f"{info_mh['global_devices']} global devices")

    import jax.numpy as jnp

    from ..problem import synthetic
    from ..solver import lm
    from ..solver.options import SolverOptions

    if args.dtype is None:
        args.dtype = "f64" if jax.default_backend() == "cpu" else "f32"
    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)

    t0 = time.perf_counter()
    if args.config:
        ba = synthetic.CONFIGS[args.config](scale=args.scale,
                                            seed=args.seed, dtype=dtype)
        problem, params0 = ba.problem, ba.params0
        name = args.config
    else:
        from ..io import bal
        problem, params0 = bal.load_bal(args.bal, dtype=dtype)
        name = args.bal

    solver = (args.linear_solver
              or CONFIG_SOLVER_DEFAULTS.get(args.config or "", "dense_schur"))
    options = SolverOptions(
        linear_solver=solver, preconditioner=args.preconditioner,
        trust_region_strategy=args.trust_region_strategy,
        check_gradients=args.check_gradients,
        max_iterations=args.max_iterations,
        max_cg_iterations=args.max_cg_iterations, cg_eta=args.cg_eta,
        function_tolerance=args.function_tolerance, verbose=args.verbose)

    print(f"[rsba_tpu] problem {name}: {int(jnp.sum(problem.obs.mask))} "
          f"observations, {params0.n_poses} poses, "
          f"{params0.n_points} points | solver={solver} "
          f"dtype={args.dtype} backend={jax.default_backend()} "
          f"devices={len(jax.devices())}"
          + (" [sharded]" if args.shard else ""))

    callback = None
    ckpt = None
    resume_summary = None
    if args.checkpoint_dir:
        from ..utils import SolverCheckpointer
        ckpt = SolverCheckpointer(args.checkpoint_dir, options=options)
        callback = ckpt.callback
        if args.resume:
            restored = ckpt.restore()
            if restored is not None:
                it0, params0, radius = restored
                options = options.__class__(
                    **{**options.__dict__, "initial_radius": radius})
                history = ckpt.restore_history()
                if history:
                    from ..solver.summary import Summary
                    resume_summary = Summary(iterations=history)
                    resume_summary.num_successful_steps = sum(
                        1 for it in history if it.accepted)
                    resume_summary.num_unsuccessful_steps = sum(
                        1 for it in history if not it.accepted)
                    # True initial cost = cost BEFORE the first accepted
                    # step (record.cost is the post-step cost; adding the
                    # step's decrease reconstructs it; history[0].cost
                    # would understate a resumed run's total cost
                    # reduction).
                    resume_summary.initial_cost = (
                        history[0].cost + history[0].cost_change)
                print(f"[rsba_tpu] resumed from checkpoint step {it0} "
                      f"(radius {radius:.3e}, "
                      f"{len(history)} prior iteration records)")

    fns = None
    info = None
    if args.shard:
        from .. import dist
        mesh = dist.make_mesh()
        fns = None
        if options.linear_solver in ("auto", "banded_schur"):
            # Prefer the banded window solver sharded along trajectory
            # rows (one band psum per LM iteration, collective-free CG);
            # fall back to the flat landmark-sharded PCG solver when the
            # problem has no window structure.
            try:
                fns = dist.make_sharded_window_solver_fns(problem, options,
                                                          mesh)
            except ValueError as e:
                if options.linear_solver == "banded_schur":
                    raise
                print(f"[rsba_tpu] window layout unavailable ({e}); "
                      "using the flat sharded solver")
        if fns is None:
            options = options.__class__(
                **{**options.__dict__, "linear_solver": "iterative_schur"})
            problem, params0, info = dist.repartition_by_point(
                problem, params0, n_shards=mesh.devices.size)
            problem, params0 = dist.shard_ba(problem, params0, mesh)
            fns = dist.make_sharded_solver_fns(problem, options, mesh)

    import contextlib
    trace_cm = (jax.profiler.trace(args.profile_dir) if args.profile_dir
                else contextlib.nullcontext())
    with trace_cm, compile_clock() as compiled:
        params, summary = lm.solve(problem, params0, options,
                                   callback=callback, fns=fns,
                                   summary=resume_summary)
    if ckpt is not None:
        ckpt.wait()
    wall = time.perf_counter() - t0

    if args.full_report:
        print(summary.full_report())
    else:
        print(summary.brief_report())
    print(json.dumps({
        "problem": name, "solver": summary.linear_solver,
        "evaluator": summary.evaluator, "dtype": args.dtype,
        "termination": summary.termination,
        "final_cost": summary.final_cost,
        "final_rmse_px": summary.final_rmse,
        "final_rmse_inlier_px": summary.final_rmse_inlier,
        "iterations": summary.num_iterations,
        "solve_s": round(summary.total_time, 3),
        "compile_s": round(compiled["seconds"], 3),
        "wall_s": round(wall, 3),
    }))
    if args.jsonl:
        summary.write_jsonl(args.jsonl)
    if args.ply:
        from ..io import bal as bal_io
        out_params = params
        if info is not None:
            out_params = params.replace(
                points=info.restore_points(params.points))
        bal_io.export_ply(args.ply, out_params)
        print(f"[rsba_tpu] wrote {args.ply}")
    return 0 if summary.termination in ("CONVERGENCE", "USER_SUCCESS") else 2


if __name__ == "__main__":
    sys.exit(main())
