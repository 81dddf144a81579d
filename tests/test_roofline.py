"""utils.roofline: phase reports carry XLA cost-model placement."""
import jax.numpy as jnp
import pytest

from rsba_tpu.problem import synthetic
from rsba_tpu.solver import SolverOptions, lm
from rsba_tpu.utils import roofline

SXM = "NVIDIA H100 80GB HBM3"


def _tiny_banded():
    ba = synthetic.make_ba_problem(
        n_poses=9, n_points=120, track_len=4, rolling_shutter=True,
        rotation_interp="nlerp", pixel_noise=0.5, seed=5,
        dtype=jnp.float64, pad_to=32)
    fns = lm.make_solver_fns(ba.problem,
                             SolverOptions(linear_solver="banded_schur"))
    return ba, fns


def test_solver_report_structure():
    ba, fns = _tiny_banded()
    # The CPU backend has no published peaks; name a card so the
    # placement arithmetic runs (the times are the CPU's, checked for
    # structure only).
    rr = roofline.solver_report(fns, ba.params0, 1e4, repeats=1,
                                device_kind=SXM)
    for phase in ("prepare", "solve_step", "iteration"):
        assert rr[phase]["time_s"] > 0
    # XLA's CPU backend provides cost analysis too — check the roofline
    # fields when present (they are on this backend).
    prep = rr["prepare"]
    if "flops" in prep:
        assert prep["flops"] > 0 and prep["bytes"] > 0
        assert 0 <= prep["mfu"]
        assert prep["bound"] in ("compute", "memory")
        assert prep["roofline_util"] > 0
        # f64 phase → the f64 peak of the named card
        peak_flops = roofline.PEAKS[SXM]["float64"]
        assert prep["mfu"] == pytest.approx(
            prep["achieved_flops_s"] / peak_flops)


def test_phase_report_without_jitted_attr():
    """Callables without _jitted still get timed (no cost analysis)."""
    import jax.numpy as jnp

    def f(x):
        return jnp.sum(x * x)

    rec = roofline.phase_report(f, (jnp.ones((64,)),), repeats=1,
                                peak=roofline.peaks(SXM, jnp.float32))
    assert rec["time_s"] > 0
    assert "flops" not in rec


@pytest.mark.parametrize("kind,dtype,flops,bytes_s", [
    (SXM, jnp.float32, 67e12, 3.35e12),
    (SXM, jnp.float64, 67e12, 3.35e12),
    ("NVIDIA H100 PCIe", jnp.float32, 51e12, 2.0e12),
])
def test_peaks_by_device_kind(kind, dtype, flops, bytes_s):
    assert roofline.peaks(kind, dtype) == (flops, bytes_s)


def test_unknown_device_kind_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.peaks("NVIDIA A100-SXM4-80GB", jnp.float32)
    # solver_report looks the peaks up before timing anything: on the
    # CPU backend (device_kind "cpu") it refuses.
    ba, fns = _tiny_banded()
    with pytest.raises(ValueError, match="'cpu'"):
        roofline.solver_report(fns, ba.params0, 1e4, repeats=1)
