"""Test config: force the CPU backend with 8 virtual devices.

This is the standard JAX "fake backend" for exercising jit/shard_map
sharding without a multi-GPU host (SURVEY.md §4e): the multi-device tests
build a jax.sharding.Mesh over 8 host-CPU devices. The platform is set
through jax.config before the first backend use. Tests marked ``gpu`` skip
here; chip_smoke.py runs them on the card without this file (--noconftest).
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
# NO persistent compile cache on the CPU backend: XLA:CPU's AOT executable
# (de)serialization does not round-trip host machine features in this
# jaxlib (cpu_aot_loader warns "+prefer-no-gather is not supported on the
# host machine ... could lead to execution errors such as SIGILL") and large
# cached 8-device executables intermittently segfault on cache read / abort
# on cache write. Compile-time cost of a cold suite is the price of not
# crashing.


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


# Every compiled XLA:CPU executable holds hundreds of JIT code mappings
# (~600-700 for a render graph on the 8-device backend); the full suite
# crosses the kernel's vm.max_map_count (65530 default) about two thirds
# in, at which point LLVM's JIT segfaults on the next compile (observed as
# deterministic "Fatal Python error: Segmentation fault" inside
# backend_compile_and_load at a position-dependent test). Dropping the jit
# caches unmaps them (measured: 3514 -> 599 maps), so clear when the map
# count nears the limit — rare enough (~2-3 times a full run) that the
# recompile cost is minor.
_MAPS_LIMIT = 40_000


@pytest.fixture(autouse=True)
def _jit_map_pressure_guard():
    yield
    try:
        with open("/proc/self/maps") as f:
            n = sum(1 for _ in f)
    except OSError:
        return
    if n > _MAPS_LIMIT:
        jax.clear_caches()
