"""Test configuration: run the suite on CPU with x64 and 8 virtual devices.

The solver itself is dtype-parametric (f32 on the GPU); derivative
validation against finite differences — the reference's core quality gate
(`/root/reference/src/integrators/_integrators.jl:97-242`) — needs f64, and
multi-chip sharding tests emulate an 8-device mesh on CPU as the driver does.
"""

import os

# JAX may already be imported when this runs, so JAX_PLATFORMS in os.environ
# can be read too late — use jax.config instead (effective as long as no
# backend has been initialized yet). XLA_FLAGS is read at backend-init time,
# so setting it here still works.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    # `-m gpu` runs the tests that need the card on the card; everything
    # else runs on the CPU
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    """Drop the previous module's compiled programs. A worker that has
    compiled a whole module's programs (test_golden.py) segfaults inside the
    XLA:CPU compiler on the next large sharded program
    (tests/README-cache-crash.md); starting each module clean avoids it."""
    jax.clear_caches()
    yield


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -m gpu tests/` on the card")

# Retry-once for worker-crash test failures. The XLA:CPU compiler
# intermittently SEGFAULTs this jaxlib during large while_loop compiles
# (three captured stacks: backend_compile_and_load, and two in the
# persistent-cache write path — tests/README-cache-crash.md). The crash is
# environment-level and non-deterministic (a different test each run);
# xdist replaces the dead worker, and this hook reschedules the crashed
# test once instead of reporting a spurious failure.
_crash_retried = set()


def pytest_handlecrashitem(crashitem, report, sched):
    if crashitem in _crash_retried:
        return
    try:
        sched.mark_test_pending(crashitem)
    except (AttributeError, NotImplementedError):
        return  # scheduler can't reschedule (loadgroup/loadscope) — keep F
    _crash_retried.add(crashitem)
    report.outcome = "rerun"


# NO persistent compilation cache in tests. The XLA:CPU executable
# serialize/write path (`jax compilation_cache.put_executable_and_time`)
# intermittently SEGFAULTs or aborts the worker process on this jaxlib —
# this, not memory pressure, was the "xdist worker crashed" flake;
# forensics in tests/README-cache-crash.md. Tests simply compile fresh:
# determinism is worth the extra minutes here.
jax.config.update("jax_compilation_cache_dir", None)
