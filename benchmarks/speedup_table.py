"""Five-config wall-to-convergence speedup table.

BASELINE.json:6-12 judges FIVE workloads.  For each judged config this
script

  1. solves on the default device (the GPU) with the preset engine,
     f32, on-device loop — exactly what bench.py measures for config 4;
  2. computes wall-to-convergence with bench.wall_to_convergence (time
     until 99.9 % of the total cost decrease, compile excluded);
  3. divides the STRONGEST stored CPU baseline for the same config —
     "strongest" = smallest wall_to_conv over every stored solver
     variant, i.e. the most pessimistic denominator for the GPU —
     from benchmarks/baselines/cpu_config4.json (all five configs are
     stored there, key "config@scale:solver"; see BASELINE.md for the
     Ceres-stand-in caveat that applies to every row).

Writes benchmarks/SPEEDUPS.json and prints one summary line per config.

Run on a GPU machine:
    PYTHONPATH=. python benchmarks/speedup_table.py
"""
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import bench  # repo-root bench.py: run(), wall_to_convergence()

OUT = pathlib.Path(__file__).parent / "SPEEDUPS.json"
BASELINES = pathlib.Path(__file__).parent / "baselines" / "cpu_config4.json"

CONFIG_ORDER = ["gs_small", "gs_bal", "rs_video_linear",
                "rs_slerp_robust", "rs_mhost_pcg"]


def strongest_cpu(baselines: dict, config: str, scale: float):
    """Smallest stored wall_to_conv across solver variants for config."""
    prefix = f"{config}@{scale}:"
    best = None
    for key, rec in baselines.items():
        if key.startswith(prefix) or key == f"{config}@{scale}":
            if best is None or rec["wall_to_conv_s"] < best[1]["wall_to_conv_s"]:
                best = (key, rec)
    return best


def main():
    import jax

    from rsba_tpu.solver.options import SolverOptions
    from rsba_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()

    baselines = json.loads(BASELINES.read_text())
    scale = float(os.environ.get("RSBA_BENCH_SCALE", "1.0"))
    only = os.environ.get("RSBA_SPEEDUP_ONLY")

    rows = []
    for config in CONFIG_ORDER:
        if only and config != only:
            continue
        opts = SolverOptions(linear_solver="auto",
                             preconditioner="schur_jacobi",
                             max_cg_iterations=100, cg_eta=1e-2,
                             max_iterations=60)
        t0 = time.perf_counter()
        ba, fns, s, model = bench.run(config, scale, "f32", opts)
        setup_s = time.perf_counter() - t0
        wall = bench.wall_to_convergence(s)
        total = sum(i.wall_time for i in s.iterations)
        cpu = strongest_cpu(baselines, config, scale)
        row = {
            "config": config,
            "scale": scale,
            "engine": f"{s.linear_solver}/{s.evaluator}",
            "device": str(jax.devices()[0]),
            "wall_to_conv_s": round(wall, 4),
            "total_s": round(total, 4),
            "lm_iterations": len(s.iterations),
            "iters_per_sec": round(len(s.iterations) / max(total, 1e-9), 2),
            "termination": s.termination,
            "final_rmse_inlier_px": round(s.final_rmse_inlier, 4),
            "setup_s": round(setup_s, 1),
        }
        if model is not None:
            row["wall_attribution"] = "cg-weighted (bench.calibrate_attempt_model)"
        if cpu is not None:
            key, rec = cpu
            row["cpu_key"] = key
            row["cpu_wall_to_conv_s"] = round(rec["wall_to_conv_s"], 4)
            row["cpu_final_rmse_px"] = round(rec["final_rmse"], 4)
            row["speedup_vs_strongest_cpu"] = round(
                rec["wall_to_conv_s"] / max(wall, 1e-9), 1)
        else:
            row["cpu_key"] = None
            row["speedup_vs_strongest_cpu"] = None
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = {
        "note": ("wall-to-convergence (99.9% of cost decrease, compile "
                 "excluded) on the GPU vs the STRONGEST stored "
                 "XLA-CPU f64 baseline per config (smallest denominator "
                 "over solver variants).  CPU tier is this framework on "
                 "XLA-CPU, a Ceres stand-in — see BASELINE.md caveat; "
                 "worst-case Ceres discount is 10x."),
        "rows": rows,
    }
    if not only:
        OUT.write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
