"""Profiling hooks — the analog of the reference's timing/tracing utilities.

The reference times structure compilation and per-callback costs on the
host (`/root/reference/benchmark/benchmarks.jl:23-38`). Under XLA the two
useful levels are:

* :func:`time_structure_build` — host wall time of the trace-time work
  (problem lowering, Riccati eligibility analysis, operator construction):
  the analog of the reference's "structure build" timings;
* :func:`trace` — a context manager around any solve that writes a
  TensorBoard/Perfetto device trace via ``jax.profiler`` (per-op device
  timings, HBM transfers, fusion boundaries) — the device-level profiler
  the reference has no analog of.

Example::

    from directtrajopt_tpu.utils.profiling import trace, time_structure_build

    print(time_structure_build(problem))       # {'make_nlp_s': ..., ...}
    with trace("/tmp/dtx_trace"):
        solve_batch(batch).kkt_error.block_until_ready()
    # then: tensorboard --logdir /tmp/dtx_trace  (or open in Perfetto)
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "time_structure_build"]


@contextlib.contextmanager
def trace(logdir: str):
    """Device-level profiler trace around a block (jax.profiler.trace).

    Remember to ``block_until_ready`` inside the block — dispatch returns
    before the device finishes, and un-awaited work lands outside the trace.
    """
    with jax.profiler.trace(logdir):
        yield


def time_structure_build(problem, backend: str = "auto") -> dict:
    """Host wall time of the trace-time structure work, per stage.

    Returns seconds for: problem lowering (``make_nlp``), Riccati
    eligibility + static structure (``analyze``), and operator construction.
    These run once per (problem structure, dtype) at trace time; they are
    the on-device analog of the reference's sparsity-structure compilation
    (`src/solvers/evaluator.jl:99-289`).
    """
    from ..solvers.canonical import make_nlp
    from ..solvers.solve import _make_ops

    out = {}
    t0 = time.perf_counter()
    nlp = make_nlp(problem)
    out["make_nlp_s"] = time.perf_counter() - t0

    if backend in ("auto", "riccati"):
        from ..solvers.ops_riccati import analyze

        t0 = time.perf_counter()
        struct = analyze(nlp)
        out["analyze_s"] = time.perf_counter() - t0
        out["riccati_eligible"] = struct is not None
        if struct is not None:
            out["n_promoted_chains"] = int(struct.promo_jr.shape[1])
            out["n_border_rows"] = int(
                len(struct.bp_steps)
                + len(struct.lin_border_rows)
                + sum(c.constraint_dim(nlp.layout) for c in nlp.eq_cons)
            )

    t0 = time.perf_counter()
    _make_ops(nlp, backend)
    out["make_ops_s"] = time.perf_counter() - t0
    return out
