#!/usr/bin/env python
"""Run the solver's main paths once on the GPU and check what comes out.

    python chip_smoke.py              # one card
    python chip_smoke.py --chips 4    # the sharded path on four cards only

One card — every phase in f32 with ``matmul_precision="highest"`` (no
TF32), through the entry points a user calls:

* solve phases: ``rsba_tpu.cli.run.main`` with the per-config preset
  solver on gs_small, gs_bal, rs_video_linear and rs_slerp_robust, each
  at scale 1.0 (the full BASELINE.json size).  The final inlier RMSE must
  match the stored CPU-f64 result in benchmarks/baselines/cpu_config4.json
  to a relative RMSE_RTOL (f32 against f64 on the same problem);
* session phase: a 50-frame rolling-shutter ``SfmSession`` (bootstrap,
  registration, triangulation, windowed BA, final full BA) in f32 with
  shape buckets.  The final BA must converge, and its inlier RMSE and the
  relative-rotation error against ground truth must stay under
  SESSION_MAX_RMSE_PX and SESSION_MAX_ROT_ERR_RAD.

Four cards (``--chips 4``): one process drives all four over a 1-D mesh
and runs the sharded solver (``--shard``) against the same problem solved
on one card — rs_mhost_pcg (config 5, scale 1.0) on the row-sharded
banded solver, and gs_bal on the landmark-sharded flat solver against
one-card iterative_schur.  Final cost and inlier RMSE must agree to a
relative SHARD_RTOL.

No hand-written kernel is on these paths: every kernel is XLA's, compiled
for the card.  The script exits non-zero, printing no result line, when
the first JAX device is not a GPU or any phase fails; the last line of a
passing run is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import subprocess
import sys
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parent
BASELINES = REPO / "benchmarks" / "baselines" / "cpu_config4.json"

#: relative tolerance of an f32 final inlier RMSE against the f64 result
RMSE_RTOL = 1e-3
#: relative tolerance of sharded against one-card final cost and RMSE
SHARD_RTOL = 1e-3
#: session limits: 2x the injected pixel noise; relative-rotation error
SESSION_MAX_RMSE_PX = 1.0
SESSION_MAX_ROT_ERR_RAD = 5e-3

#: (config, baseline key) for the one-card solve phases
SOLVE_PHASES = (
    ("gs_small", "gs_small@1.0:banded_schur"),
    ("gs_bal", "gs_bal@1.0:iterative_schur"),
    ("rs_video_linear", "rs_video_linear@1.0:banded_schur"),
    ("rs_slerp_robust", "rs_slerp_robust@1.0:banded_schur"),
)


class PhaseFailed(Exception):
    pass


def card_line() -> str:
    """The card's name and power limit, read before JAX starts."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return "nvidia-smi not found"
    return r.stdout.strip() or f"nvidia-smi rc={r.returncode}"


def peak_bytes() -> int:
    import jax
    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in jax.local_devices())


def cli_solve(argv) -> dict:
    """Run the CLI in this process; return its JSON record."""
    from rsba_tpu.cli import run as cli_run

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_run.main(list(argv))
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="")
    recs = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    if not recs:
        raise PhaseFailed(f"no JSON record from the CLI (rc={rc})")
    rec = recs[-1]
    rec.update(rc=rc, phase_s=wall, peak_bytes_in_use=peak_bytes())
    return rec


def report(name: str, rec: dict) -> None:
    print(f"phase {name}: engine={rec['solver']}/{rec['evaluator']} "
          f"termination={rec['termination']} "
          f"lm_iterations={rec['iterations']} "
          f"compile_s={rec['compile_s']} solve_s={rec['solve_s']} "
          f"phase_s={rec['phase_s']:.3f} "
          f"peak_bytes_in_use={rec['peak_bytes_in_use']}", flush=True)


def check_converged(name: str, rec: dict) -> None:
    if rec["termination"] != "CONVERGENCE" or rec["rc"] != 0:
        raise PhaseFailed(f"{name}: termination {rec['termination']} "
                          f"(rc {rec['rc']})")


def check_rel(name: str, what: str, got: float, ref: float,
              rtol: float) -> None:
    rel = abs(got - ref) / abs(ref)
    ok = rel <= rtol
    print(f"  {name} {what}: {got:.6g} vs {ref:.6g} rel_err={rel:.3e} "
          f"tol={rtol:g} {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise PhaseFailed(f"{name}: {what} off by {rel:.3e} > {rtol:g}")


def solve_phase(config: str, ref_rmse: float, scale: float = 1.0) -> None:
    rec = cli_solve([f"--config={config}", f"--scale={scale}",
                     "--dtype=f32"])
    report(config, rec)
    check_converged(config, rec)
    check_rel(config, "final inlier RMSE (px)", rec["final_rmse_inlier_px"],
              ref_rmse, RMSE_RTOL)


def session_phase(n_frames: int = 50, n_points: int = 1200) -> None:
    """50-frame f32 rolling-shutter SfmSession end to end."""
    import jax.numpy as jnp
    import numpy as np

    from rsba_tpu.geometry import quaternion as quat
    from rsba_tpu.pipeline import SfmSession
    from rsba_tpu.problem import synthetic
    from rsba_tpu.solver.options import SolverOptions
    from rsba_tpu.utils.compilation import compile_clock

    ba = synthetic.make_ba_problem(
        n_poses=n_frames + 1, n_points=n_points, track_len=8,
        rolling_shutter=True, rotation_interp="nlerp",
        use_distortion=False, pixel_noise=0.5, seed=11,
        dtype=jnp.float32, name="session")
    obs = ba.problem.obs
    m = np.asarray(obs.mask) > 0
    pa = np.asarray(obs.pose_a)[m]
    pid = np.asarray(obs.point)[m]
    uv = np.asarray(obs.uv)[m]
    intr = np.asarray(ba.params_gt.intr[0])

    t0 = time.perf_counter()
    with compile_clock() as compiled:
        sess = SfmSession(
            intr, ba.problem.model, ba.image_size, window=8, ba_interval=4,
            dtype=jnp.float32, shape_buckets=True,
            options=SolverOptions(linear_solver="auto", max_iterations=25))
        for f in range(n_frames):
            sel = pa == f
            sess.add_frame(pid[sel], uv[sel], rows=uv[sel, 1])
        t_ingest = time.perf_counter() - t0
        s = sess.bundle_adjust(window=None)
    wall = time.perf_counter() - t0

    q_est, _, _ = sess.reconstruction()
    q_gt = np.asarray(ba.params_gt.q)[:n_frames]
    rel_est = quat.relative(jnp.asarray(q_est[:-1]), jnp.asarray(q_est[1:]))
    rel_gt = quat.relative(jnp.asarray(q_gt[:-1]), jnp.asarray(q_gt[1:]))
    rot_err = float(np.max(np.abs(
        np.linalg.norm(np.asarray(quat.to_axis_angle(rel_est)), axis=-1)
        - np.linalg.norm(np.asarray(quat.to_axis_angle(rel_gt)), axis=-1))))
    registered = sum(bool(r) for r in sess.registered)
    print(f"phase session: engine={s.linear_solver}/{s.evaluator} "
          f"termination={s.termination} lm_iterations={s.num_iterations} "
          f"frames={n_frames} registered={registered} "
          f"map_points={len(sess.points)} compile_s={compiled['seconds']:.3f} "
          f"ingest_s={t_ingest:.3f} solve_s={wall:.3f} "
          f"peak_bytes_in_use={peak_bytes()}", flush=True)
    if s.termination != "CONVERGENCE" or registered != n_frames:
        raise PhaseFailed(f"session: termination {s.termination}, "
                          f"{registered}/{n_frames} frames registered")
    for what, got, lim in (
            ("final inlier RMSE (px)", s.final_rmse_inlier,
             SESSION_MAX_RMSE_PX),
            ("max relative-rotation error (rad)", rot_err,
             SESSION_MAX_ROT_ERR_RAD)):
        ok = got <= lim
        print(f"  session {what}: {got:.6g} limit={lim:g} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise PhaseFailed(f"session: {what} {got:.4g} > {lim:g}")


def sharded_phase(config: str, one_card_solver: str,
                  scale: float = 1.0) -> None:
    """``--shard`` over every device against one-card ``one_card_solver``."""
    base = [f"--config={config}", f"--scale={scale}", "--dtype=f32"]
    one = cli_solve(base + [f"--linear-solver={one_card_solver}"])
    report(f"{config}@1card", one)
    shard = cli_solve(base + ["--shard"])
    report(f"{config}@sharded", shard)
    for name, rec in ((f"{config}@1card", one),
                      (f"{config}@sharded", shard)):
        check_converged(name, rec)
    check_rel(config, "sharded final cost", shard["final_cost"],
              one["final_cost"], SHARD_RTOL)
    check_rel(config, "sharded final inlier RMSE (px)",
              shard["final_rmse_inlier_px"], one["final_rmse_inlier_px"],
              SHARD_RTOL)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded phases, on four cards")
    args = ap.parse_args(argv)

    print(card_line(), flush=True)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (first device platform "
              f"{devices[0].platform!r}); nothing was run", file=sys.stderr)
        return 1
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
              f"found {len(devices)}", file=sys.stderr)
        return 1

    from rsba_tpu.solver.options import SolverOptions
    from rsba_tpu.utils.compilation import enable_compile_cache

    cache = enable_compile_cache()
    print(f"device_kind={devices[0].device_kind} devices={len(devices)} "
          f"jax={jax.__version__} dtype=f32 "
          f"matmul_precision={SolverOptions().matmul_precision} "
          f"compile_cache={cache}", flush=True)

    if args.chips == 4:
        phases = [("rs_mhost_pcg sharded",
                   lambda: sharded_phase("rs_mhost_pcg", "auto")),
                  ("gs_bal sharded",
                   lambda: sharded_phase("gs_bal", "iterative_schur"))]
    else:
        refs = json.loads(BASELINES.read_text())
        phases = [(config, lambda c=config, k=key:
                   solve_phase(c, refs[k]["final_rmse"]))
                  for config, key in SOLVE_PHASES]
        phases.append(("session", session_phase))

    failed = []
    for name, run in phases:
        try:
            run()
        except Exception:      # reported, and the script then exits 1
            traceback.print_exc()
            print(f"phase {name}: FAILED", flush=True)
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
