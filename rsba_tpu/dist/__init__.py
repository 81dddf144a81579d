"""Distributed (multi-chip / multi-host) bundle adjustment.

SURVEY.md §2.9 / §5.8: observations are partitioned by camera block —
equivalently by landmark ownership, since feature tracks are contiguous
frame windows — across a `jax.sharding.Mesh`; Schur-complement, gradient
and cost contributions reduce via `psum` across devices; trust-region state
is replicated.  The reference has no distributed layer (it is a
single-process, shared-memory C++ solver); this subsystem is the
multi-device scaling design mandated by BASELINE.json's north star.
"""
from .banded_sharded import make_sharded_window_solver_fns
from .mesh import initialize_multihost, make_mesh, shard_ba
from .partition import PartitionInfo, repartition_by_point
from .sharded import make_sharded_solver_fns

__all__ = [
    "make_mesh", "shard_ba", "PartitionInfo", "repartition_by_point",
    "make_sharded_solver_fns", "make_sharded_window_solver_fns",
]
