"""Throughput batch solving + convergence forensics.

Two round-3 capabilities on the standard N=51 bilinear benchmark family:

* ``solve_batch_compact`` — the on-device multi-phase compacting scheduler
  (what bench.py runs): every phase runs as 128-lane compacted chunks
  inside one jitted program, so stragglers never hold the
  whole batch hostage and no host round trips separate the phases.
* ``telemetry`` — an on-device per-iteration optimizer-state ring
  (objective, inf_pr, inf_du, mu, KKT error, alpha, delta_w, theta), the
  analog of the reference's ``update_optimizer_state_history`` — convergence
  forensics without host callbacks inside jit.

Run: ``python examples/06_throughput_and_telemetry.py [float32|float64]``.
float32 (the default, for a GPU) solves 256 lanes to 1e-5; float64 enables
x64 and solves 8 lanes to 1e-8.
"""

import os
import sys
import time

import numpy as np
import jax

DTYPE = sys.argv[1] if len(sys.argv) > 1 else "float32"
F32 = DTYPE == "float32"
if not F32:
    jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import directtrajopt_tpu as dtx
from directtrajopt_tpu.benchmarks import make_batched_bilinear_problems, make_bilinear_problem

B = 256 if F32 else 8

# ---- throughput: compacted multi-phase batch solve ------------------------ #
batch = make_batched_bilinear_problems(B, N=51, feasible_start=True)
kw = dict(
    mu_init=3e-2,
    tol=1e-5 if F32 else 1e-8,
    acceptable_tol=5e-4 if F32 else 1e-6,
    acceptable_iter=1,
    hessian_approximation="gauss_newton",
)
res = dtx.solve_batch_compact(
    batch, phases=((16, None), (16, 1e-3), (64, 1e-3)), chunk=128, **kw
)
res.kkt_error.block_until_ready()  # compile
t0 = time.time()
res = dtx.solve_batch_compact(
    batch, phases=((16, None), (16, 1e-3), (64, 1e-3)), chunk=128, **kw
)
conv = int(np.asarray(res.converged).sum())
res.kkt_error.block_until_ready()
wall = time.time() - t0
print(f"compact batch: {conv}/{B} converged in {wall:.3f}s = {conv / wall:.0f} solves/s")
it = np.asarray(res.iterations)
print(f"iterations med/p95/max: {np.median(it):.0f}/{np.percentile(it, 95):.0f}/{it.max()}")

# ---- forensics: per-iteration telemetry on one solve ---------------------- #
prob = make_bilinear_problem(N=51, feasible_start=True)
tele = dtx.telemetry(128)
r1 = dtx.solve(prob, callbacks=tele, max_iter=120, mu_init=3e-2)
k = int(r1.iterations)
hs = np.asarray(r1.ipm.history_stats)[: k + 1]
cols = dict(zip(dtx.TELEMETRY_COLUMNS, hs.T))
print(f"\nsingle solve: {k} iterations, status {int(r1.status)}")
print("it    mu        kkt       theta     alpha   delta_w")
for i in range(0, k + 1, max(1, k // 8)):
    print(
        f"{i:3d}  {cols['mu'][i]:.1e}  {cols['kkt_error'][i]:.1e}  "
        f"{cols['theta'][i]:.1e}  {cols['alpha'][i]:.3f}  {cols['delta_w'][i]:.1e}"
    )
