"""rsba_tpu — a rolling-shutter bundle-adjustment framework in JAX.

A from-scratch nonlinear least-squares solver for structure-from-motion
bundle adjustment of rolling-shutter video, built on jax/XLA: batched
residual/Jacobian evaluation, Schur-complement landmark elimination,
blocked Cholesky and preconditioned CG on the accelerator, and
multi-device scaling via `jax.sharding` meshes with XLA collectives.

Capability parity target: henrique/rsba + the Ceres Solver feature surface
it exposes (see SURVEY.md).  Not a port — a batched-accelerator redesign.
"""

__version__ = "0.1.0"

from . import geometry
from .geometry import CameraModel, Loss, intrinsics_vector

__all__ = ["geometry", "CameraModel", "Loss", "intrinsics_vector",
           "SfmSession"]


def __getattr__(name):
    # Lazy: pipeline pulls in the solver stack; keep bare `import rsba_tpu`
    # light for geometry-only users.
    if name == "SfmSession":
        from .pipeline import SfmSession
        return SfmSession
    raise AttributeError(name)
