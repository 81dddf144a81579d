"""XLA compilation: the persistent compile cache and a compile-time clock."""
from __future__ import annotations

import contextlib
import os
import pathlib

import jax

#: cache directory used when JAX_COMPILATION_CACHE_DIR is unset: fixed and
#: inside the checkout (the path is part of the cache key, so it must not
#: move between runs); listed in .gitignore
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"

#: jax.monitoring duration events counted as compile time: lowering to
#: MLIR and the backend compile (which also covers a persistent-cache
#: retrieval).  Tracing is left out: a jit traced inside another's trace
#: reports its own duration within the outer one.
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else DEFAULT_CACHE_DIR."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(DEFAULT_CACHE_DIR))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`cache_dir`.

    Executables that took at least a second to compile are kept.
    Returns the directory.
    """
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


@contextlib.contextmanager
def compile_clock():
    """Yield a one-entry dict whose ``"seconds"`` accumulates the
    COMPILE_EVENTS durations recorded inside the ``with`` block."""
    acc = {"seconds": 0.0}

    def listener(event, duration, **_):
        if event in COMPILE_EVENTS:
            acc["seconds"] += duration

    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        yield acc
    finally:
        jax.monitoring.unregister_event_duration_listener(listener)
