"""Suite-wide fixtures.

The full suite compiles thousands of distinct XLA executables in one
process; each holds live memory mappings, and the process crosses the
kernel's ``vm.max_map_count`` (65530 by default) around ~500 tests in —
at which point the next compiler ``mmap`` fails and XLA segfaults.
Dropping the jit caches between test modules releases the mappings
(verified: map count returns to baseline after ``jax.clear_caches()``)
and bounds the suite's footprint at the cost of cross-module cache
reuse, which only ever saved recompiles of the handful of shared entry
points.
"""
import gc

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_mappings():
    yield
    jax.clear_caches()
    gc.collect()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); "
        "skips elsewhere")
