"""Restoration fallback + infeasibility detection.

The reference inherits robustness on infeasible/degenerate problems from
Ipopt's restoration phase (filtered around in
`/root/reference/src/solvers/ipopt_solver/callbacks.jl:194-200`). The
lockstep-batch analog is a feasibility direction folded into the line-search
trial grid plus a local-infeasibility certificate; deliberately infeasible
problems must terminate with a *meaningful* status — not a silent iteration
burn (VERDICT r1 item 4).

Status codes: 0 optimal, 1 acceptable, 2 iteration limit, 3 callback stop,
4 locally infeasible (certified), 5 restoration failed (stalled).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import directtrajopt_tpu as dtx

G_DRIFT = np.array([[0.0, 1.0], [-1.0, 0.0]])
G_DRIVE = np.array([[0.0, 1.0], [1.0, 0.0]])


def _base_traj(N=12, dt=0.1, seed=0):
    rng = np.random.default_rng(seed)
    return dtx.Trajectory.create(
        {
            "x": rng.normal(size=(N, 2)),
            "u": 0.1 * rng.normal(size=(N, 1)),
        },
        timestep=dt,
        controls="u",
        initial={"x": [1.0, 0.0]},
    )


def _problem(traj, extra_constraints=()):
    integ = dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", traj)
    return dtx.DirectTrajOptProblem.create(
        traj,
        dtx.QuadraticRegularizer.create("u", traj, 1.0),
        integ,
        constraints=list(extra_constraints),
    )


def test_certified_infeasible_nonlinear():
    """x₀² + 1 = 0 has no solution; the feasibility problem is stationary at
    x₀ = 0, so the certificate (status 4) must fire well before max_iter."""
    traj = _base_traj()
    con = dtx.NonlinearKnotPointConstraint.create(
        lambda x: x[0] ** 2 + 1.0, "x", traj, equality=True, times=[5]
    )
    prob = _problem(traj, [con])
    res = dtx.solve(prob, max_iter=300)
    assert not bool(res.converged)
    assert int(res.status) == 4
    assert int(res.iterations) < 300


def test_certified_infeasible_two_point():
    """Two contradictory nonlinear equalities on the same knot value."""
    traj = _base_traj()
    c1 = dtx.NonlinearKnotPointConstraint.create(
        lambda x: jnp.sum(x**2) - 1.0, "x", traj, equality=True, times=[4]
    )
    c2 = dtx.NonlinearKnotPointConstraint.create(
        lambda x: jnp.sum(x**2) + 1.0, "x", traj, equality=True, times=[4]
    )
    prob = _problem(traj, [c1, c2])
    res = dtx.solve(prob, max_iter=300)
    assert not bool(res.converged)
    # the pair is certifiably infeasible (residuals differ by a constant) —
    # either the certificate or the stall exit must fire early
    assert int(res.status) in (4, 5)
    assert int(res.iterations) < 300


def test_bound_blocked_duration_infeasible():
    """Duration pinned to a value the dt bounds cannot reach: θ gets trapped
    at the bound. Must terminate early with a diagnosable status (4 or 5),
    not converge."""
    N = 12
    rng = np.random.default_rng(1)
    traj = dtx.Trajectory.create(
        {
            "x": rng.normal(size=(N, 2)),
            "u": 0.1 * rng.normal(size=(N, 1)),
            "dt": np.full((N, 1), 0.1),
        },
        timestep="dt",
        controls="u",
        initial={"x": [1.0, 0.0]},
        bounds={"dt": (0.01, 0.2)},
    )
    # max reachable duration = 0.2·(N−1) = 2.2 < 10
    con = dtx.DurationConstraint(10.0)
    prob = _problem(traj, [con])
    res = dtx.solve(prob, max_iter=400)
    assert not bool(res.converged)
    assert int(res.status) in (4, 5)
    assert int(res.iterations) < 400


def test_feasible_bad_start_still_converges():
    """Restoration must help, not hurt: a feasible problem from a wildly
    infeasible start still converges."""
    rng = np.random.default_rng(3)
    N = 14
    traj = dtx.Trajectory.create(
        {
            "x": 50.0 * rng.normal(size=(N, 2)),
            "u": 10.0 * rng.normal(size=(N, 1)),
        },
        timestep=0.1,
        controls="u",
        initial={"x": [1.0, 0.0]},
        bounds={"u": 2.0},
    )
    prob = _problem(traj)
    res = dtx.solve(prob, max_iter=300)
    assert bool(res.converged)
    assert int(res.status) in (0, 1)


def test_riccati_backend_restoration():
    """The restoration path runs through the Riccati backend's resolve too."""
    traj = _base_traj(seed=7)
    con = dtx.NonlinearKnotPointConstraint.create(
        lambda x: x[0] ** 2 + 1.0, "x", traj, equality=True, times=[3]
    )
    prob = _problem(traj, [con])
    res = dtx.solve(prob, max_iter=300, backend="riccati")
    assert not bool(res.converged)
    assert int(res.status) in (4, 5)
    assert int(res.iterations) < 300


def test_no_rest_trials_option():
    """n_rest_trials=0 restores the plain backtracking grid."""
    traj = _base_traj(seed=5)
    prob = _problem(traj)
    res = dtx.solve(prob, max_iter=200, n_rest_trials=0)
    assert bool(res.converged)
