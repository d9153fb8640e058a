"""Solver callbacks — the on-device analog of the reference's ``Callbacks``
module (`/root/reference/src/solvers/ipopt_solver/callbacks.jl`) and the
solver-agnostic ``AbstractIntermediateCallback`` contract
(`src/solvers/_solvers.jl:21-59`).

The reference's callbacks run in the Ipopt C loop; ours run inside the jitted
``lax.while_loop``, split by where each capability naturally lives:

* **host monitoring** (``say_hello``, iteration printers, external loggers):
  a Python function invoked per iteration through ``jax.debug.callback`` with
  a summary dict (iter, μ, objective, KKT error, θ) and optionally the primal;
* **device stop conditions** (``stop_iteration``, ``rollout_fidelity``'s
  fidelity-threshold early stop): a pure predicate ``(Z, iter) -> bool``
  evaluated in the loop body — batched instances stop independently;
* **on-device history** (``update_trajectory_history``): a static-size ring
  buffer of iterates carried through the loop and returned with the result —
  also the mid-solve checkpoint story (the reference syncs the trajectory
  every iteration so Ctrl-C keeps progress; here the history ring plays that
  role since the device loop is atomic);
* **best-snapshot tracking** (``best_rollout_fidelity``): a score function
  whose argmax iterate is carried and returned.
"""

from __future__ import annotations

from functools import lru_cache as _lru_cache
from typing import Callable

import jax.numpy as jnp

from ..module import module, static_field
from ..rollout import rollout_fidelity

__all__ = [
    "IPMCallbacks",
    "say_hello",
    "stop_iteration",
    "wall_clock_stop",
    "fidelity_stop",
    "best_fidelity_tracker",
    "telemetry",
]


@module
class IPMCallbacks:
    """Composable per-iteration hooks for :func:`ipm_solve`.

    Fields (all optional):
      * ``host_fn(info: dict) -> None`` — called on the host each iteration
        (through ``jax.debug.callback``; arrays are batched under vmap).
      * ``include_primal`` — also pass the primal iterate ``Z`` to host_fn.
      * ``stop_fn(Z, iteration) -> bool`` — device-side early-stop predicate,
        checked every ``stop_every`` iterations.
      * ``history_size`` — keep a ring buffer of the last K iterates.
      * ``telemetry_size`` — keep a ring of per-iteration optimizer-state rows
        (objective, inf_pr, inf_du, μ, KKT error, α, δ_w, θ — see
        :data:`~directtrajopt_tpu.solvers.ipm.TELEMETRY_COLUMNS`), returned as
        ``result.ipm.history_stats``. The on-device analog of the reference's
        ``update_optimizer_state_history``
        (`/root/reference/src/solvers/ipopt_solver/callbacks.jl:221-361`).
      * ``score_fn(Z) -> scalar`` — track the best-scoring iterate seen.
    """

    host_fn: Callable | None = static_field(default=None)
    include_primal: bool = static_field(default=False)
    stop_fn: Callable | None = static_field(default=None)
    stop_every: int = static_field(default=1)
    # host-interactive stop: ``host_stop_fn(info: dict) -> bool`` runs on the
    # HOST every ``host_stop_every`` iterations via ``jax.experimental.
    # io_callback`` and its boolean return halts the device loop — the full
    # power of the reference's intermediate-callback contract (wall-clock
    # budgets, interactive abort) that the pure-device ``stop_fn`` cannot
    # express and ``host_fn`` (fire-and-forget) cannot feed back. Each poll
    # costs a host round trip, so keep ``host_stop_every`` coarse.
    host_stop_fn: Callable | None = static_field(default=None)
    host_stop_every: int = static_field(default=8)
    history_size: int = static_field(default=0)
    telemetry_size: int = static_field(default=0)
    score_fn: Callable | None = static_field(default=None)
    # keep the K best-scoring iterates (reference best_rollout_fidelity
    # retains the K best trajectories, `callbacks.jl:221-361`); 1 = classic
    # single best (result.ipm.best_Z). K>1 adds (K,)/(K, z) rings exposed as
    # result.ipm.topk_scores / topk_Z (unsorted; order by the scores).
    score_top_k: int = static_field(default=1)

    def merged_with(self, other: "IPMCallbacks | None") -> "IPMCallbacks":
        if other is None:
            return self
        return IPMCallbacks(
            host_fn=self.host_fn or other.host_fn,
            include_primal=self.include_primal or other.include_primal,
            stop_fn=self.stop_fn or other.stop_fn,
            stop_every=min(self.stop_every, other.stop_every),
            host_stop_fn=self.host_stop_fn or other.host_stop_fn,
            host_stop_every=min(self.host_stop_every, other.host_stop_every),
            history_size=max(self.history_size, other.history_size),
            telemetry_size=max(self.telemetry_size, other.telemetry_size),
            score_fn=self.score_fn or other.score_fn,
            score_top_k=max(self.score_top_k, other.score_top_k),
        )


def say_hello(name: str = "solver") -> IPMCallbacks:
    """Reference `callbacks.jl` ``say_hello`` — host print each iteration."""

    def hello(info):
        print(f"hello from {name}: iteration {info['iteration']}")

    return IPMCallbacks(host_fn=hello)


def telemetry(size: int = 128) -> IPMCallbacks:
    """Record per-iteration optimizer state on device (reference
    ``callback_update_optimizer_state_history``, `callbacks.jl:62-89`):
    a ``(size, 8)`` ring of (objective, inf_pr, inf_du, μ, KKT error, α, δ_w,
    θ) rows returned as ``result.ipm.history_stats`` — convergence forensics
    without host callbacks inside jit. Row ``i % size`` describes iteration
    ``i``; valid rows are ``history_stats[:min(iterations, size)]`` when the
    run fits the ring."""
    return IPMCallbacks(telemetry_size=size)


def wall_clock_stop(max_seconds: float, every: int = 8) -> IPMCallbacks:
    """Stop the solve once ``max_seconds`` of wall time have elapsed,
    measured from the solve's first poll (so compile time is excluded; the
    clock re-anchors whenever a poll sees iteration 0, i.e. at each new
    solve reusing this callback object). The host analog of the reference's
    wall-clock intermediate callback — the device loop is halted with
    status 3 and the in-flight iterate preserved. Also reachable as
    ``solve(prob, max_wall_time=30.0)``."""
    import time as _time

    import numpy as _onp

    start = [None]

    def over_budget(info):
        now = _time.monotonic()
        # iteration is a scalar (or a batch under vmap); min==0 marks the
        # first poll of a fresh solve — re-anchor the budget there
        if start[0] is None or int(_onp.min(info["iteration"])) == 0:
            start[0] = now
        return (now - start[0]) > max_seconds

    return IPMCallbacks(host_stop_fn=over_budget, host_stop_every=every)


@_lru_cache(maxsize=None)
def _wall_stop_cached(max_seconds: float, every: int = 8) -> IPMCallbacks:  # noqa: used by ipm.py's max_wall_time path
    """Cached :func:`wall_clock_stop` instance for the ``max_wall_time``
    option path: repeated ``solve_jit(prob, max_wall_time=30.0)`` calls must
    reuse ONE callback object (callbacks are static under jit — a fresh
    closure per call would recompile every time)."""
    return wall_clock_stop(max_seconds, every)


def stop_iteration(max_iterations: int) -> IPMCallbacks:
    """Stop after a fixed number of iterations
    (`callbacks.jl` ``callback_stop_iteration``)."""
    return IPMCallbacks(stop_fn=lambda Z, it: it >= max_iterations)


def fidelity_stop(
    integrator,
    traj_template,
    goal,
    fid_threshold: float = 0.999,
    every: int = 1,
    x_name: str | None = None,
) -> IPMCallbacks:
    """Early stop when the rolled-out fidelity crosses a threshold
    (`callbacks.jl` ``callback_rollout_fidelity_factory``) — the rollout runs
    on device inside the solve loop."""
    goal = jnp.asarray(goal)

    def stop(Z, it):
        tr = traj_template.from_zvec(Z)
        fid = rollout_fidelity(integrator, tr, goal, x_name)
        return fid >= fid_threshold

    return IPMCallbacks(stop_fn=stop, stop_every=every)


def best_fidelity_tracker(
    integrator, traj_template, goal, x_name: str | None = None, top_k: int = 1
) -> IPMCallbacks:
    """Track the iterate(s) with the best rolled-out fidelity
    (`callbacks.jl` ``best_rollout_fidelity`` — which retains the K best
    snapshots; pass ``top_k`` for the same behavior here)."""
    goal = jnp.asarray(goal)

    def score(Z):
        tr = traj_template.from_zvec(Z)
        return rollout_fidelity(integrator, tr, goal, x_name)

    return IPMCallbacks(score_fn=score, score_top_k=top_k)
