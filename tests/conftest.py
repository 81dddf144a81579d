"""Test configuration: CPU backend with 8 virtual devices.

Per SURVEY.md §4.2: tests run on the CPU backend (fast, deterministic,
float64 available for oracles) with 8 virtual devices so every `shard_map`
/ mesh code path is exercised as on a multi-GPU host.  The GPU itself is
exercised by `chip_smoke.py`.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses we spawn
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: XLA compiles dominate suite wall time (the
# problems themselves are tiny); repeat runs hit the disk cache instead.
from rsba_tpu.utils.compilation import enable_compile_cache  # noqa: E402

enable_compile_cache()
