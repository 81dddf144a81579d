"""Frozen dataclasses registered as JAX pytrees.

The problem, plan and evaluation records are dataclasses whose array
fields are pytree leaves (traced under ``jit``) and whose remaining
fields — camera model, loss, grid sizes — are static metadata: they are
part of the jit cache key, so changing one retraces.
"""
from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    """Copy with the given fields replaced (``dataclasses.replace``)."""
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls=None, *, static: tuple = ()):
    """Make ``cls`` a frozen dataclass and register it as a pytree.

    ``static`` names the fields registered as ``meta_fields``; every
    other field is a data field.  The class gains ``.replace(**changes)``.
    Use as ``@pytree_dataclass`` or ``@pytree_dataclass(static=(...))``.
    """
    def wrap(cls):
        cls = dataclasses.dataclass(frozen=True)(cls)
        names = [f.name for f in dataclasses.fields(cls)]
        unknown = set(static) - set(names)
        if unknown:
            raise TypeError(f"{cls.__name__}: static names unknown fields "
                            f"{sorted(unknown)}")
        jax.tree_util.register_dataclass(
            cls, data_fields=[n for n in names if n not in static],
            meta_fields=list(static))
        cls.replace = _replace
        return cls

    return wrap if cls is None else wrap(cls)
