"""Roofline / MFU accounting for the solver's hot phases.

BASELINE.json:5 requires "Jacobian+Schur-solve per iteration at
speed-of-light per chip" with efficiency reported.  This module measures
each jitted phase (prepare = evaluate+assemble, solve_step = damped Schur
solve) and combines wall time with XLA's own cost model
(``compiled.cost_analysis()`` — flops and bytes accessed) into:

* achieved FLOP/s and device-memory bytes/s,
* MFU           = achieved FLOP/s / peak FLOP/s,
* bandwidth util = achieved bytes/s / peak bytes/s,
* arithmetic intensity and the roofline bound (compute- vs memory-bound
  classification with the bound's utilization — on a memory-bound phase
  the honest "speed of light" is the bandwidth roofline).

Peaks come from :data:`PEAKS`, keyed by ``device_kind``; the FLOP/s peak
is the one of the dtype the phase ran in.  A device that is not in the
table is an error, not a default.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import numpy as np

_H100_SOURCE = "NVIDIA H100 Tensor Core GPU data sheet (dense rates)"

#: Published peaks per ``device_kind``: FLOP/s per dtype and device-memory
#: bytes/s.  float64 is the tensor-core rate, which XLA's f64 matrix
#: products reach through cuBLAS (outside the tensor cores: 34 TFLOP/s
#: on SXM, 26 on PCIe).  Rates assume the card's full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {          # SXM5
        "float32": 67e12, "float64": 67e12, "bytes_s": 3.35e12,
        "source": _H100_SOURCE + ", SXM"},
    "NVIDIA H100 PCIe": {
        "float32": 51e12, "float64": 51e12, "bytes_s": 2.0e12,
        "source": _H100_SOURCE + ", PCIe"},
}


def peaks(device_kind: str, dtype) -> tuple:
    """(peak FLOP/s in ``dtype``, peak bytes/s) of ``device_kind``.

    Raises ValueError for a device that is not in :data:`PEAKS`.
    """
    entry = PEAKS.get(device_kind)
    if entry is None:
        raise ValueError(f"no published peaks for device kind "
                         f"{device_kind!r}; known: {sorted(PEAKS)}")
    return entry[np.dtype(dtype).name], entry["bytes_s"]


def _cost_analysis(call: Callable, args) -> Optional[dict]:
    """flops / bytes from XLA's cost model for a phase-fn wrapper.

    Phase wrappers built by the solver factories carry their underlying
    ``jax.jit`` function and bound leading arguments as ``_jitted`` /
    ``_bound`` attributes; lowering with identical avals hits the jit
    cache, so this does not recompile.
    """
    jf = getattr(call, "_jitted", None)
    if jf is None:
        return None
    bound = getattr(call, "_bound", ())
    # Lower under the SAME matmul precision the timed wrapper traces with
    # — precision is part of the trace context, so a different one would
    # both recompile and cost-model a different executable.
    precision = getattr(call, "_precision", None) or "default"
    try:
        with jax.default_matmul_precision(precision):
            ca = jf.lower(*bound, *args).compile().cost_analysis()
    except Exception:
        return None
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else None
    if not ca:
        return None
    return {"flops": float(ca.get("flops", 0.0)),
            "bytes": float(ca.get("bytes accessed", 0.0))}


def _time_call(call: Callable, args, repeats: int = 5,
               pipeline: int = 20) -> float:
    """Per-execution time with dispatch latency amortized.

    Dispatches ``pipeline`` async calls back-to-back and blocks once:
    jax dispatch is asynchronous, so the per-call dispatch latency
    overlaps device execution instead of serializing with it (the device
    LM loop, lm_device.py, pays it zero times).  ``repeats`` best-of
    rounds guard against background noise.
    """
    jax.block_until_ready(call(*args))
    best = float("inf")
    while True:
        try:
            for _ in range(repeats):
                t0 = time.perf_counter()
                outs = [call(*args) for _ in range(pipeline)]
                jax.block_until_ready(outs)
                best = min(best, (time.perf_counter() - t0) / pipeline)
                del outs
            return best
        except Exception as e:
            # Deep pipelines hold `pipeline` copies of the phase output
            # alive at once — a memory-fat phase (e.g. dense_schur's aux)
            # can exhaust HBM (surfaces as JaxRuntimeError from
            # block_until_ready or ValueError at dispatch).  Halve the
            # depth and retry; latency amortization degrades gracefully.
            if "RESOURCE_EXHAUSTED" not in str(e) or pipeline <= 2:
                raise
            # Drain the queue first: the failed attempt's in-flight
            # executions still hold their output buffers, so an
            # immediate retry OOMs again regardless of depth.
            try:
                jax.block_until_ready(call(*args))
            except Exception:
                pass
            pipeline //= 2
            best = float("inf")


def phase_report(call: Callable, args, repeats: int = 5,
                 peak: Optional[tuple] = None) -> dict:
    """Measure one phase: wall time, plus its roofline placement against
    ``peak`` = (FLOP/s, bytes/s) when given and XLA's cost model covers
    the phase."""
    t = _time_call(call, args, repeats)
    rec = {"time_s": t}
    ca = _cost_analysis(call, args) if peak is not None else None
    if ca and ca["flops"] > 0:
        peak_flops, peak_bw = peak
        ai = ca["flops"] / max(ca["bytes"], 1.0)
        ridge = peak_flops / peak_bw
        rec.update({
            "flops": ca["flops"],
            "bytes": ca["bytes"],
            "achieved_flops_s": ca["flops"] / t,
            "achieved_bytes_s": ca["bytes"] / t,
            "mfu": ca["flops"] / t / peak_flops,
            "bandwidth_util": ca["bytes"] / t / peak_bw,
            "arithmetic_intensity": ai,
            "bound": "compute" if ai >= ridge else "memory",
            # utilization against the binding roofline — the honest
            # "fraction of speed-of-light" figure
            "roofline_util": (ca["flops"] / t / peak_flops if ai >= ridge
                              else ca["bytes"] / t / peak_bw),
        })
    return rec


def solver_report(fns: dict, params, radius, repeats: int = 5,
                  device_kind: Optional[str] = None) -> dict:
    """prepare + solve_step rooflines for an lm.make_solver_fns dict.

    ``params`` in external layout; converted when the engine is
    window-native.  ``device_kind`` (default: the first device's) selects
    the peaks; an unknown one raises before anything is timed.  Returns
    {"prepare": {...}, "solve_step": {...}, "iteration": {...}} where
    "iteration" sums the phases (the per-LM-iteration cost BASELINE.json:5
    asks to place on the roofline).
    """
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    peak = peaks(device_kind, params.dtype)
    to_internal = fns.get("to_internal")
    p = to_internal(params) if to_internal is not None else params
    prep = phase_report(fns["prepare"], (p,), repeats, peak)
    aux = fns["prepare"](p)
    import jax.numpy as jnp
    r = jnp.asarray(radius, aux["cost"].dtype)
    step = phase_report(fns["solve_step"], (aux, r), repeats, peak)
    it = {"time_s": prep["time_s"] + step["time_s"]}
    if "flops" in prep and "flops" in step:
        peak_flops, peak_bw = peak
        f = prep["flops"] + step["flops"]
        b = prep["bytes"] + step["bytes"]
        it.update({"flops": f, "bytes": b,
                   "mfu": f / it["time_s"] / peak_flops,
                   "bandwidth_util": b / it["time_s"] / peak_bw})
    return {"prepare": prep, "solve_step": step, "iteration": it}
