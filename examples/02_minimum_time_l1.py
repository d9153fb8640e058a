"""Minimum-time bilinear problem: free Δt per knot with MinimumTimeObjective,
control bounds, and exact-L1 slack constraints on the control increments."""

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)  # f64 tolerances
import jax.numpy as jnp

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import directtrajopt_tpu as dtx

G_drift = np.array([[0.0, 1.0], [-1.0, 0.0]])
G_drive = np.array([[0.0, 1.0], [1.0, 0.0]])
integ = dtx.BilinearIntegrator.create((G_drift, [G_drive]), "x", "u", None)

N = 30
u0 = 0.3 * np.sin(np.linspace(0, 5, N))[:, None]
xs = dtx.bilinear_rollout(integ, jnp.array([1.0, 0.0]), jnp.asarray(u0), 0.12)

traj = dtx.Trajectory.create(
    {
        "x": np.asarray(xs),
        "u": u0,
        "du": np.zeros((N, 1)),
        "sl": 0.2 * np.ones((N, 1)),
        "dt": np.full((N, 1), 0.12),
    },
    timestep="dt",
    controls=("u", "du"),
    initial={"x": [1.0, 0.0]},
    final={"x": np.asarray(xs[-1])},
    bounds={"u": 0.8, "sl": (0.0, np.inf), "dt": (0.04, 0.3)},
)
integrators = [integ, dtx.DerivativeIntegrator.create("u", "du", traj)]
obj = (
    dtx.QuadraticRegularizer.create("u", traj, 0.5)
    + 0.2 * dtx.LinearRegularizer.create("sl", traj, 1.0)   # exact L1 on |du|
    + 0.5 * dtx.MinimumTimeObjective.create(traj)
)
cons = [dtx.L1SlackConstraint.create("du", "sl", traj)]
prob = dtx.DirectTrajOptProblem.create(traj, obj, integrators, constraints=cons)

res = dtx.solve(prob, max_iter=300, tol=1e-7)
tr = res.problem.trajectory
du = np.asarray(tr.data["du"][:, 0])
print(
    f"converged={bool(res.converged)} duration={float(tr.get_duration()):.3f} "
    f"(from {0.12*(N-1):.3f}), sparse du: {int(np.sum(np.abs(du) < 1e-5))}/{N} zeros"
)
