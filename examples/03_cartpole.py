"""Cartpole swing-up via the general RK4 integrator: 4-state nonlinear
dynamics, N=100 knots, control bounds + a nonlinear path constraint on cart
position. Swing-up is encouraged by a terminal cost (soft goal), which keeps
the problem well-posed from a cold start."""

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)  # f64 tolerances
import jax.numpy as jnp

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import directtrajopt_tpu as dtx

# state x = (p, ṗ, θ, θ̇), control u = horizontal force; θ=0 is upright
mc, mp, l, g = 1.0, 0.1, 0.5, 9.81


def f(x, u):
    p, dp, th, dth = x
    F = u[0]
    sin, cos = jnp.sin(th), jnp.cos(th)
    denom = mc + mp * sin**2
    ddp = (F + mp * sin * (l * dth**2 + g * cos)) / denom
    ddth = (-F * cos - mp * l * dth**2 * cos * sin - (mc + mp) * g * sin) / (l * denom)
    return jnp.array([dp, ddp, dth, ddth])


N, dt = 100, 0.05
integ = dtx.GeneralIntegrator.create(f, "x", "u", scheme="rk4")

rng = np.random.default_rng(0)
x0 = np.array([0.0, 0.0, np.pi, 0.0])  # hanging
goal = np.array([0.0, 0.0, 0.0, 0.0])  # upright

traj = dtx.Trajectory.create(
    {
        "x": np.linspace(x0, goal, N) + 0.01 * rng.normal(size=(N, 4)),
        "u": 0.1 * rng.normal(size=(N, 1)),
    },
    timestep=dt,
    controls="u",
    initial={"x": x0},
    bounds={"u": 10.0},
)
obj = dtx.QuadraticRegularizer.create("u", traj, 1e-2) + dtx.TerminalObjective(
    lambda x: jnp.sum((x - jnp.asarray(goal)) ** 2), "x", traj, Q=200.0
)
cons = [
    dtx.NonlinearKnotPointConstraint.create(
        lambda x: jnp.array([x[0] ** 2 - 4.0]), "x", traj, equality=False
    )  # |cart position| ≤ 2
]
prob = dtx.DirectTrajOptProblem.create(traj, obj, integ, constraints=cons)
res = dtx.solve(prob, max_iter=500, tol=1e-6, acceptable_tol=1e-4)
tr = res.problem.trajectory
xN = np.asarray(tr.data["x"][-1])
print(
    f"converged={bool(res.converged)} status={int(res.status)} "
    f"iters={int(res.iterations)}"
)
print(f"final state {np.round(xN, 3)} (goal {goal})")
print("max |p|:", float(np.max(np.abs(np.asarray(tr.data['x'][:, 0])))))
