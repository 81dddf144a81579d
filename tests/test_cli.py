"""CLI runner tests (SURVEY.md §2 C20/C23 — service-frontend parity).

The solver-bearing tests invoke ``rsba_tpu.cli.run.main`` in-process:
a subprocess pays a second jax init + compile cache and gets starved by
the parent's XLA thread pools inside the full suite (measured 43 s →
409 s).  Argument parsing + exit codes for the true console entry are
covered by the one cheap subprocess test at the bottom.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_main(capsys, *argv) -> tuple:
    from rsba_tpu.cli import run as cli_run
    rc = cli_run.main(list(argv))
    out = capsys.readouterr().out
    return rc, out


def last_json(stdout: str) -> dict:
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line in output:\n{stdout}")


def test_cli_gs_small(tmp_path, capsys):
    jsonl = tmp_path / "iters.jsonl"
    ply = tmp_path / "cloud.ply"
    rc, out = run_main(
        capsys, "--config=gs_small", "--scale=0.05", "--max-iterations=15",
        f"--jsonl={jsonl}", f"--ply={ply}", "--full-report")
    assert rc == 0, out[-2000:]
    rec = last_json(out)
    assert rec["termination"] == "CONVERGENCE"
    assert rec["final_rmse_px"] < 0.8
    assert "Solver Report" in out
    assert jsonl.exists() and len(jsonl.read_text().splitlines()) >= 1
    assert ply.read_text().startswith("ply")


def test_cli_sharded_rs(capsys):
    rc, out = run_main(
        capsys, "--config=rs_video_linear", "--scale=0.02", "--shard",
        "--max-iterations=25")
    assert rc == 0, out[-2000:]
    rec = last_json(out)
    assert rec["termination"] == "CONVERGENCE"
    assert rec["evaluator"] == "xla-window-sharded"
    assert "[sharded]" in out


def test_cli_f64_enables_x64_on_accelerator(capsys, monkeypatch):
    """--dtype f64 turns on x64 whatever the backend (not only on CPU)."""
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    jax.config.update("jax_enable_x64", False)
    try:
        rc, out = run_main(capsys, "--config=gs_small", "--scale=0.05",
                           "--max-iterations=15", "--dtype=f64")
        assert jax.config.jax_enable_x64
    finally:
        jax.config.update("jax_enable_x64", True)
    assert rc == 0, out[-2000:]
    rec = last_json(out)
    assert rec["dtype"] == "f64"
    assert "backend=gpu" in out


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero and prints no result line without a
    GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_cli_rejects_unknown_config():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "rsba_tpu.cli.run", "--config=nonsense"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 2
    assert "invalid choice" in r.stderr


def test_cli_bal_file(tmp_path, capsys):
    """--bal path: solve a BAL-convention problem file through the CLI."""
    from tests.test_bal_io import _make_bal_file

    path, _ = _make_bal_file(tmp_path)
    rc, out = run_main(capsys, f"--bal={path}", "--max-iterations=60",
                       "--function-tolerance=1e-5",
                       "--linear-solver=dense_schur")
    assert rc == 0, out[-2000:]
    rec = last_json(out)
    assert rec["termination"] == "CONVERGENCE"
