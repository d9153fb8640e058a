"""README quick-example: 2-state bilinear system, 1 control, N=50 knots,
QuadraticRegularizer, fixed Δt, x_1 pinned, x_N goal (feasible via rollout)."""

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)  # f64 tolerances
import jax.numpy as jnp

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import directtrajopt_tpu as dtx

G_drift = np.array([[0.0, 1.0], [-1.0, 0.0]])
G_drive = np.array([[0.0, 1.0], [1.0, 0.0]])
integrator = dtx.BilinearIntegrator.create((G_drift, [G_drive]), "x", "u", None)

N, dt = 50, 0.1
u_guess = 0.3 * np.sin(np.linspace(0, 6.28, N))[:, None]
xs = dtx.bilinear_rollout(integrator, jnp.array([1.0, 0.0]), jnp.asarray(u_guess), dt)

traj = dtx.Trajectory.create(
    {"x": np.asarray(xs), "u": u_guess},
    timestep=dt,
    controls="u",
    initial={"x": [1.0, 0.0]},
    final={"x": np.asarray(xs[-1])},
    bounds={"u": 1.0},
)
prob = dtx.DirectTrajOptProblem.create(
    traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), integrator
)
print(prob)
res = dtx.solve(prob, max_iter=100)
print(
    f"converged={bool(res.converged)} iters={int(res.iterations)} "
    f"kkt={float(res.kkt_error):.2e} obj={float(res.objective):.6f}"
)
print("fidelity:", float(dtx.rollout_fidelity(integrator, res.problem.trajectory, xs[-1])))
