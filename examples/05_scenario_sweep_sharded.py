"""Scenario sweep: vmapped bilinear problems with randomized initial
controls, sharded across all available devices (the GPUs of a host; virtual
CPU devices for a dry run: run with
XLA_FLAGS=--xla_force_host_platform_device_count=8)."""

import time

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)  # f64 tolerances

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import directtrajopt_tpu as dtx
from directtrajopt_tpu.benchmarks import make_batched_bilinear_problems
from directtrajopt_tpu.parallel import make_mesh, solve_batch_sharded

n_dev = len(jax.devices())
B = 32 * n_dev
print(f"{n_dev} devices, batch {B}")

batch = make_batched_bilinear_problems(B, N=51, feasible_start=True)
mesh = make_mesh()

t0 = time.time()
res = solve_batch_sharded(
    batch, mesh=mesh, max_iter=120, tol=1e-5, acceptable_tol=5e-4, acceptable_iter=5
)
res.kkt_error.block_until_ready()
wall = time.time() - t0
conv = int(np.asarray(res.converged).sum())
print(
    f"solved {conv}/{B} in {wall:.1f}s (incl. compile) -> "
    f"{conv/wall:.1f} solves/s across {n_dev} devices"
)
