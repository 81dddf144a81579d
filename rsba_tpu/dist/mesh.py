"""Mesh construction and problem sharding specs.

One 1-D mesh axis ``"dp"`` spans all devices (XLA routes the psums: NVLink
within a host, the network across hosts; SURVEY.md §5.8).  Multi-host
entry is `jax.distributed.initialize()` + the same code: `Mesh` over
`jax.devices()` is global across processes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..problem.types import Observations, Params, Problem

AXIS = "dp"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> dict:
    """Multi-host process bootstrap (SURVEY.md §4.2 item 5, §5.8).

    Calls ``jax.distributed.initialize`` — under SLURM or Open MPI the
    three arguments are detected from the launcher's environment, so the
    line each process runs is simply::

        python -m rsba_tpu.cli.run --config=rs_mhost_pcg --shard --multihost

    Elsewhere pass --coordinator=HOST:PORT --num-processes=N
    --process-id=I to every process.  After initialization
    ``jax.devices()`` spans every process and :func:`make_mesh` builds
    the global mesh; asserts that it does.

    Returns {"process_id", "process_count", "global_devices",
    "local_devices"} for logging.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    if jax.process_count() > 1 and not n_global > n_local:
        raise RuntimeError(
            f"multi-host init saw {jax.process_count()} processes but the "
            f"global device list ({n_global}) does not exceed the local "
            f"one ({n_local}) — the mesh would not span the processes")
    return {"process_id": jax.process_index(),
            "process_count": jax.process_count(),
            "global_devices": n_global, "local_devices": n_local}


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis,))


def problem_specs(problem: Problem, axis: str = AXIS) -> Problem:
    """PartitionSpec pytree matching Problem: obs + points sharded, rest
    replicated.  Static fields (model/loss) are copied so the treedef
    matches the source problem's."""
    obs = Observations(uv=P(axis), t=P(axis), pose_a=P(axis), pose_b=P(axis),
                       intr_idx=P(axis), point=P(axis), mask=P(axis))
    return Problem(obs=obs, pose_free=P(), point_free=P(axis),
                   intr_free=P(), intr_basis=P(), model=problem.model,
                   loss=problem.loss)


def params_specs(axis: str = AXIS) -> Params:
    return Params(q=P(), c=P(), intr=P(), points=P(axis))


def shard_ba(problem: Problem, params: Params, mesh: Mesh,
             axis: str = AXIS) -> tuple[Problem, Params]:
    """device_put the (repartitioned) problem/params onto the mesh."""
    def put(tree, specs):
        return jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree,
            specs)

    problem = problem.replace(
        obs=put(problem.obs, problem_specs(problem, axis).obs),
        pose_free=put(problem.pose_free, P()),
        point_free=put(problem.point_free, P(axis)),
        intr_free=put(problem.intr_free, P()),
        intr_basis=put(problem.intr_basis, P()))
    params = put(params, params_specs(axis))
    return problem, params
