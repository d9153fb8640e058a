"""Qubit gate synthesis: bilinear Schrödinger dynamics (4D Pauli state) with
2 drives, even control symmetry, N=100 knots, then a warm-started MPC
re-solve loop tracking a perturbed state."""

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)  # f64 tolerances
import jax.numpy as jnp

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import directtrajopt_tpu as dtx
from directtrajopt_tpu.benchmarks import pauli_generators

Gx, Gy, Gz = pauli_generators()
G = (0.1 * Gz, [Gx, Gy])
integ = dtx.BilinearIntegrator.create(G, "x", "u", None, method="taylor")

N, dt = 100, 0.1
rng = np.random.default_rng(1)
u0 = 0.05 * rng.standard_normal((N, 2))
x0 = np.array([1.0, 0.0, 0.0, 0.0])
goal = jnp.asarray([0.0, 1.0, 0.0, 0.0])  # X gate
xs = dtx.bilinear_rollout(integ, jnp.asarray(x0), jnp.asarray(u0), dt)

traj = dtx.Trajectory.create(
    {"x": np.asarray(xs), "u": u0},
    timestep=dt,
    controls="u",
    initial={"x": x0},
    bounds={"u": 0.3},
)
obj = dtx.QuadraticRegularizer.create("u", traj, 0.1) + dtx.TerminalObjective(
    lambda x: 1.0 - jnp.dot(goal, x) ** 2, "x", traj, Q=500.0
)
cons = [dtx.SymmetricControlConstraint("u", [0, 1], even=True, include_timestep=False)]
prob = dtx.DirectTrajOptProblem.create(traj, obj, integ, constraints=cons)

res = dtx.solve(prob, max_iter=300, tol=1e-7)
fid = float(dtx.rollout_fidelity(integ, res.problem.trajectory, goal))
print(f"gate synthesis: converged={bool(res.converged)} fidelity={fid:.6f}")
u = np.asarray(res.problem.trajectory.data["u"])
print("symmetry residual:", float(np.max(np.abs(u - u[::-1]))))

# MPC: perturb the measured state and re-solve warm-started
prob_cur = res.problem
for step in range(3):
    xs_now = dtx.rollout(integ, prob_cur.trajectory)
    measured = np.asarray(xs_now[1]) + 1e-3 * rng.standard_normal(4)
    measured /= np.linalg.norm(measured)
    prob_cur = dtx.mpc_step(prob_cur, {"x": measured})
    r = dtx.solve(prob_cur, max_iter=100, tol=1e-7)
    prob_cur = r.problem
    print(f"mpc step {step}: converged={bool(r.converged)} iters={int(r.iterations)}")
