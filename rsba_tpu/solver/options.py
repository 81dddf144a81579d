"""Solver configuration — parity with ``ceres::Solver::Options`` (SURVEY.md
§2 C23), trimmed to the knobs that exist in this framework."""
from __future__ import annotations

import dataclasses

LINEAR_SOLVERS = ("auto", "dense", "dense_schur", "iterative_schur",
                  "banded_schur")
PRECONDITIONERS = ("jacobi", "schur_jacobi", "cluster_jacobi")


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver knobs (hashable → jit-stable).

    Trust-region semantics follow Ceres's Levenberg-Marquardt strategy:
    damping λ = 1/μ with μ the trust-region radius, radius grown by
    1/max(1/3, 1−(2ρ−1)³) on accepted steps and halved-with-backoff on
    rejections.
    """
    # Outer loop.  trust_region_strategy: "lm" (Levenberg-Marquardt,
    # default) or "dogleg" (Ceres TRADITIONAL_DOGLEG — requires an exact
    # step solver: linear_solver "dense" or "dense_schur").
    trust_region_strategy: str = "lm"
    max_iterations: int = 50
    initial_radius: float = 1e4
    max_radius: float = 1e16
    min_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    max_invalid_steps: int = 5         # consecutive non-finite-step budget

    # Linear solver.  "auto" (default) picks the banded window solver
    # when the problem's track structure admits it, falling back to iterative_schur on the flat layout otherwise.
    linear_solver: str = "auto"
    # PCG preconditioner.  "jacobi" / "schur_jacobi" apply to both the
    # flat iterative_schur and banded solvers ("jacobi" on the banded
    # path aliases schur_jacobi: the band's d=0 diagonal blocks ARE the
    # Schur-Jacobi blocks).  "cluster_jacobi" — the visibility-clustered
    # tier (Ceres CLUSTER_JACOBI analogue) — has two implementations:
    # on the banded video path, contiguous 16-pose segments of the band
    # factored dense (the trajectory IS the co-visibility structure); on
    # the flat iterative_schur path, greedy co-visibility agglomeration
    # of the camera graph with per-cluster dense blocks of S
    # (solver/cluster.py — unordered/BAL-style problems).
    preconditioner: str = "schur_jacobi"
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    jacobi_scaling: bool = True
    # PCG (iterative_schur): max iterations and the forcing-sequence eta
    # (Ceres: Solver::Options::max_linear_solver_iterations / eta).
    max_cg_iterations: int = 100
    cg_eta: float = 1e-2
    # Iterative refinement sweeps after dense Cholesky (f32 robustness —
    # SURVEY.md §7.2 item 1).
    refinement_steps: int = 1
    # Matmul precision for solver computations.  The default lets f32
    # matmuls run in reduced precision (TF32 on the GPU's tensor cores,
    # ~10 mantissa bits) — too coarse for normal equations.  "highest"
    # keeps full f32 products and accumulation.
    matmul_precision: str = "highest"

    # On-device LM loop (solver/lm_device.py): the whole trust-region
    # loop runs in one lax.while_loop dispatch — only scalars and the
    # per-attempt record table return to the host.  "auto" = use it when
    # the selected engine exposes raw phase functions (both banded window
    # engines do); "on" requires it (raises otherwise); "off" = the
    # host-driven loop, which pays dispatch and read-back latency on
    # every phase of every iteration.
    device_loop: str = "auto"
    # With a per-iteration callback installed (checkpointing), the device
    # loop returns to the host every ~device_block_iters outer iterations
    # so the callback still fires.  0 = never (single dispatch; callback
    # then fires once at the end).
    device_block_iters: int = 8

    # Runtime gradient verification (Ceres Solver::Options::check_gradients
    # / GradientChecker, SURVEY.md C25): before solving, compare autodiff
    # block Jacobians against central finite differences on a sample of
    # observations; raise on mismatch.  The tolerance is dtype-aware in
    # lm.solve (FD in f32 floors at ~1e-3).
    check_gradients: bool = False
    gradient_check_relative_precision: float = 0.0   # 0 = dtype default

    # Reporting
    verbose: bool = False

    def __post_init__(self):
        if self.linear_solver not in LINEAR_SOLVERS:
            raise ValueError(
                f"linear_solver must be one of {LINEAR_SOLVERS}, "
                f"got {self.linear_solver!r}")
        if self.preconditioner not in PRECONDITIONERS:
            raise ValueError(
                f"preconditioner must be one of {PRECONDITIONERS}, "
                f"got {self.preconditioner!r}")
        if self.trust_region_strategy not in ("lm", "dogleg"):
            raise ValueError(
                f"trust_region_strategy must be 'lm' or 'dogleg', "
                f"got {self.trust_region_strategy!r}")
        if self.device_loop not in ("auto", "on", "off"):
            raise ValueError(
                f"device_loop must be 'auto', 'on' or 'off', "
                f"got {self.device_loop!r}")
