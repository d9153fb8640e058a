"""Benchmark problem constructors.

Mirrors the reference's benchmark fixtures
(`/root/reference/benchmark/problem_utils.jl:10-77`): the standard bilinear
quantum-gate problem (4D Pauli state, 2 drives, u→du→ddu smoothness chain,
free timestep) and a dimension-configurable scaled problem — plus batched
variants that stack scenarios (random initial states / goals) into one
vmappable problem pytree, the unit of work of a batched solve — and the
headline configuration (:func:`headline_config`) that ``bench.py`` and
``chip_smoke.py`` run through :func:`run_headline`.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from .integrators import BilinearIntegrator, DerivativeIntegrator
from .objectives import QuadraticRegularizer, TerminalObjective
from .problem import DirectTrajOptProblem
from .trajectory import Trajectory

__all__ = [
    "pauli_generators",
    "make_bilinear_problem",
    "make_scaled_problem",
    "make_batched_bilinear_problems",
    "cartpole_dynamics",
    "make_cartpole_problem",
    "headline_config",
    "make_headline_batch",
    "run_headline",
    "rms_u_per_lane",
    "rms_u_vs_golden",
]

_GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden", "bilinear_n51_seed42.npz",
)


def _np_bilinear_rollout(G_drift, G_drives, x0, u, dt, order: int = 16):
    """Host-side (numpy) rollout ``x_{k+1} = exp(Δt G(u_k)) x_k``.

    Benchmark fixtures are built on the host without touching the device:
    a jitted rollout whose closure captures device-array dynamics constants
    forces a device→host fetch per constant at lowering time. The expv action uses the same Taylor–Horner chain as
    ``ops.expm.expv_taylor``; at ‖Δt·G‖ ≲ 0.6 order 16 is exact to f64.

    Shapes: x0 (..., d), u (..., N, m), dt scalar. Returns (..., N, d).
    """
    Gd = np.asarray(G_drift, dtype=np.float64)
    Gv = np.stack([np.asarray(g, dtype=np.float64) for g in G_drives])
    u = np.asarray(u, dtype=np.float64)
    N = u.shape[-2]
    xs = [np.broadcast_to(np.asarray(x0, dtype=np.float64), u.shape[:-2] + Gd.shape[:1]).copy()]
    for k in range(N - 1):
        A = dt * (Gd + np.einsum("...m,mij->...ij", u[..., k, :], Gv))
        x = xs[-1]
        y = x
        for j in range(order, 0, -1):
            y = x + np.einsum("...ij,...j->...i", A, y) / j
        xs.append(y)
    return np.stack(xs, axis=-2)


def pauli_generators():
    """Real 4D Pauli representation generators (`problem_utils.jl:15-17`)."""
    Gx = np.array(
        [[0, 0, 0, 1], [0, 0, 1, 0], [0, -1, 0, 0], [-1, 0, 0, 0]], dtype=float
    )
    Gy = np.array(
        [[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 0, -1], [0, 0, 1, 0]], dtype=float
    )
    Gz = np.array(
        [[0, 0, 1, 0], [0, 0, 0, -1], [-1, 0, 0, 0], [0, 1, 0, 0]], dtype=float
    )
    return Gx, Gy, Gz


def make_bilinear_problem(
    N: int = 51,
    seed: int = 42,
    *,
    free_time: bool = True,
    goal_objective: float | None = None,
    feasible_start: bool = False,
    taylor_order: int = 12,
) -> DirectTrajOptProblem:
    """Standard bilinear quantum-gate problem (`problem_utils.jl:10-42`):
    4D state, 2 bounded controls with derivative chain, free timestep.

    ``goal_objective``: if set, adds a terminal cost Q·‖x_N − goal‖² (the
    reference's convergence suite does the analog with an infidelity
    objective). ``feasible_start``: initialize the state by rolling out the
    initial controls instead of random data.
    """
    rng = np.random.default_rng(seed)
    dt, u_bound, omega = 0.1, 0.1, 0.1
    Gx, Gy, Gz = pauli_generators()
    G_drift = omega * Gz
    G_drives = [Gx, Gy]

    u0 = u_bound * (2 * rng.random((N, 2)) - 1)
    if feasible_start:
        x0 = _np_bilinear_rollout(
            G_drift, G_drives, np.array([1.0, 0.0, 0.0, 0.0]), u0, dt
        )
    else:
        x0 = 2 * rng.random((N, 4)) - 1

    data = {
        "x": x0,
        "u": u0,
        "du": rng.standard_normal((N, 2)),
        "ddu": rng.standard_normal((N, 2)),
    }
    bounds = {"u": u_bound}
    if free_time:
        data["dt"] = np.full((N, 1), dt)
        bounds["dt"] = (0.01, 0.5)
    traj = Trajectory.create(
        data,
        timestep="dt" if free_time else dt,
        controls=("ddu", "dt") if free_time else ("ddu",),
        initial={"x": [1.0, 0.0, 0.0, 0.0], "u": np.zeros(2)},
        final={"u": np.zeros(2)},
        goal={"x": [0.0, 1.0, 0.0, 0.0]},
        bounds=bounds,
    )
    integrators = [
        BilinearIntegrator.create(
            (G_drift, G_drives), "x", "u", traj, method="taylor",
            taylor_order=taylor_order,
        ),
        DerivativeIntegrator.create("u", "du", traj),
        DerivativeIntegrator.create("du", "ddu", traj),
    ]
    obj = QuadraticRegularizer.create("u", traj, 1.0) + QuadraticRegularizer.create(
        "du", traj, 1.0
    )
    if goal_objective is not None:
        goal = jnp.asarray([0.0, 1.0, 0.0, 0.0])
        obj = obj + TerminalObjective(
            lambda x: jnp.sum((x - goal) ** 2), "x", traj, Q=goal_objective
        )
    return DirectTrajOptProblem.create(traj, obj, integrators)


def make_scaled_problem(
    N: int, state_dim: int, n_controls: int = 2, seed: int = 42
) -> DirectTrajOptProblem:
    """Random bilinear problem with configurable dimensions
    (`problem_utils.jl:44-77`)."""
    rng = np.random.default_rng(seed)
    G_drift = rng.standard_normal((state_dim, state_dim))
    G_drives = [rng.standard_normal((state_dim, state_dim)) for _ in range(n_controls)]
    x_init = np.zeros(state_dim)
    x_init[0] = 1.0
    traj = Trajectory.create(
        {
            "x": rng.standard_normal((N, state_dim)),
            "u": 0.1 * rng.standard_normal((N, n_controls)),
            "du": rng.standard_normal((N, n_controls)),
            "dt": np.full((N, 1), 0.1),
        },
        timestep="dt",
        controls=("du", "dt"),
        initial={"x": x_init, "u": np.zeros(n_controls)},
        final={"u": np.zeros(n_controls)},
        bounds={"u": 1.0, "dt": (0.01, 0.5)},
    )
    integrators = [
        BilinearIntegrator.create((G_drift, G_drives), "x", "u", traj),
        DerivativeIntegrator.create("u", "du", traj),
    ]
    obj = QuadraticRegularizer.create("u", traj, 1.0)
    return DirectTrajOptProblem.create(traj, obj, integrators)


def make_batched_bilinear_problems(
    batch: int,
    N: int = 51,
    seed: int = 42,
    *,
    free_time: bool = True,
    feasible_start: bool = False,
    goal_objective: float | None = None,
    taylor_order: int = 12,
) -> DirectTrajOptProblem:
    """A stacked batch of bilinear problems differing in initial controls and
    state data — the vmappable unit of a scenario sweep.

    Built natively batched (one broadcast of the template + one vmapped
    rollout) instead of stacking ``batch`` Python-built problems, which would
    cost hundreds of device dispatches per instance.
    """
    template = make_bilinear_problem(
        N=N,
        seed=seed,
        free_time=free_time,
        goal_objective=goal_objective,
        feasible_start=False,
        taylor_order=taylor_order,
    )
    rng = np.random.default_rng(seed)
    dt, u_bound = 0.1, 0.1

    u0 = u_bound * (2 * rng.random((batch, N, 2)) - 1)
    if feasible_start:
        integ = template.integrators[0]
        x0 = _np_bilinear_rollout(
            integ.G_drift, integ.G_drives, np.array([1.0, 0.0, 0.0, 0.0]), u0, dt
        )
    else:
        x0 = 2 * rng.random((batch, N, 4)) - 1

    # host-side stacking: the whole batched problem is built without a
    # single device op; leaves are device-put once at solve dispatch
    stacked = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (batch,) + np.shape(x)),
        template,
    )
    data = dict(stacked.trajectory.data)
    data["x"] = x0
    data["u"] = u0
    data["du"] = rng.standard_normal((batch, N, 2))
    data["ddu"] = rng.standard_normal((batch, N, 2))
    traj = stacked.trajectory.replace(data=data)
    return stacked.replace(trajectory=traj)


def cartpole_dynamics(mc: float = 1.0, mp: float = 0.2, length: float = 0.5,
                      grav: float = 9.81):
    """Continuous cartpole dynamics ẋ = f(x, u), x = [p, ṗ, θ, θ̇].

    θ = 0 is upright. The second benchmark family: a classic mechanical
    system with a *general* nonlinear vector field (exercises
    ``GeneralIntegrator``'s RK4 path, vs the bilinear family's expm path)."""

    def f(x, u):
        _, dp, th, dth = x
        F = u[0]
        sin, cos = jnp.sin(th), jnp.cos(th)
        denom = mc + mp * sin**2
        ddp = (F + mp * sin * (length * dth**2 + grav * cos)) / denom
        ddth = (
            -F * cos - mp * length * dth**2 * cos * sin - (mc + mp) * grav * sin
        ) / (length * denom)
        return jnp.array([dp, ddp, dth, ddth])

    return f


def make_cartpole_problem(
    N: int = 40,
    seed: int = 0,
    *,
    dt: float = 0.05,
    goal_p: float = 1.0,
    u_bound: float = 10.0,
) -> DirectTrajOptProblem:
    """Cartpole cart-move problem: start balanced upright at p=0, end
    balanced upright at p=``goal_p`` (terminal cost, soft goal).

    Unlike the full swing-up (multimodal in the number of pump swings), the
    cart-move task has a locally unique optimum, so independent solvers from
    the same start land on the same solution — which is what makes it usable
    as a golden external-validation fixture (tools/make_golden.py). The seed
    only perturbs the initial guess. The control regularizer weight (0.1) is
    deliberately stiff: at 1e-2 the optimum sits in a nearly-flat u-valley
    and two independently converged solvers (gtol 1e-10 / tol 1e-9) still
    differ by RMS(u) ≈ 1.4e-4 — too flat to certify 1e-4 agreement."""
    from .integrators import GeneralIntegrator

    f = cartpole_dynamics()
    integ = GeneralIntegrator.create(f, "x", "u", scheme="rk4")
    rng = np.random.default_rng(seed)
    x0 = np.zeros(4)
    goal = np.array([goal_p, 0.0, 0.0, 0.0])
    x_guess = np.linspace(x0, goal, N) + 0.01 * rng.standard_normal((N, 4))
    u_guess = 0.1 * rng.standard_normal((N, 1))
    traj = Trajectory.create(
        {"x": x_guess, "u": u_guess},
        timestep=dt,
        controls="u",
        initial={"x": x0},
        bounds={"u": u_bound},
    )
    obj = QuadraticRegularizer.create("u", traj, 0.1) + TerminalObjective(
        lambda x: jnp.sum((x - jnp.asarray(goal)) ** 2), "x", traj, Q=100.0
    )
    return DirectTrajOptProblem.create(traj, obj, integ)


def headline_config(batch: int | None = None) -> dict:
    """The certified two-stage headline configuration, run by
    :func:`run_headline` and imported by ``bench.py``, ``chip_smoke.py`` and
    the quality-gate test so that all of them solve with the same kwargs.

    The problem is :func:`make_bilinear_problem`'s (N=51, 4-state Pauli
    bilinear, 2 bounded drives, u→du→ddu chain, free Δt) as a batch of
    ``batch`` (default 8192) lanes in f32. Solutions must match the
    independent scipy golden optimum to RMS(u) < 1e-4 (the reference's
    cross-solver agreement bar, see :func:`rms_u_vs_golden`). Two stages,
    both straggler-compacted in chunks of 256 lanes:

    1. **Seek** — Gauss-Newton IPM at the default barrier schedule to
       tol=1e-6. GN removes the window-Hessian AD pass and cuts iterations
       on this family, but plateaus near kkt 1e-7 with RMS(u) ~1.7e-4, hence
       stage 2. Straggler phases restart μ at 1e-2 primal-only. The trial
       grid is trimmed to 7 backtracking slots with no SOC or restoration
       directions: on this family they almost never win a trial, and each
       costs a resolve per iteration.
    2. **Polish** — exact-Hessian IPM warm-started per lane from the seek's
       best-KKT slacks and duals (``carry_duals`` threads them through the
       straggler phases), with error-free-transform f32 residuals
       (``compensated_residuals``) to certify kkt ≤ 1e-7 in f32.

    Taylor order 6 for the expv action: ‖Δt·G‖ ≤ 0.6 over the dt bounds, so
    it truncates at ≤6e-6; the check against the order-12 golden optimum
    certifies that the truncation does not move the optimum.

    Returns ``{"N", "batch", "taylor_order", "phase1_kw", "polish_kw"}``
    where the ``*_kw`` dicts are full kwargs for ``solve_batch_compact``.
    """
    batch = 8192 if batch is None else batch
    chunk = min(256, batch)
    phase1_kw = dict(
        tol=1e-6,
        acceptable_tol=1e-6,
        acceptable_iter=50,
        mu_init=3e-2,
        hessian_approximation="gauss_newton",
        phases=((20, None), (20, 1e-2), (96, 1e-2)),
        chunk=chunk,
        max_ls=7,
        n_rest_trials=0,
        max_soc=0,
    )
    # mu_init is nominal: the monotone barrier re-derives μ from the warm
    # point's complementarity. The "auto" regularization's spectral stage
    # clipping caps the endgame around 1e-7, so the in-basin Newton tail
    # runs the plain inertia ladder.
    polish_kw = dict(
        tol=1e-7,
        acceptable_tol=1e-7,
        mu_init=1e-5,
        bound_push=1e-9,
        bound_frac=1e-9,
        phases=((2, None), (6, None)),
        chunk=chunk,
        carry_duals=True,
        hessian_regularization="inertia",
        compensated_residuals=True,
    )
    return dict(
        N=51, batch=batch, taylor_order=6,
        phase1_kw=phase1_kw, polish_kw=polish_kw,
    )


def make_headline_batch(cfg: dict, seed: int = 42) -> DirectTrajOptProblem:
    """The headline configuration's f32 scenario batch."""
    from .solvers.solve import cast_problem

    return cast_problem(
        make_batched_bilinear_problems(
            cfg["batch"], N=cfg["N"], seed=seed, feasible_start=True,
            taylor_order=cfg["taylor_order"],
        ),
        jnp.float32,
    )


def run_headline(batch_problems, cfg):
    """Run the certified two-stage pipeline of :func:`headline_config` on a
    batched problem. Returns ``(res_polish, res_seek)`` — ``res_polish``
    carries the certified convergence flags, KKT errors and trajectories."""
    from .solvers.solve import solve_batch_compact

    res1 = solve_batch_compact(batch_problems, **cfg["phase1_kw"])
    res2 = solve_batch_compact(
        res1.problem, warm=res1.ipm.state.best_kkt_warm, **cfg["polish_kw"]
    )
    return res2, res1


def rms_u_per_lane(res) -> np.ndarray:
    """RMS(u − u*) of every lane of a solved N=51 headline batch, where u*
    is the independent scipy trust-constr f64 optimum (gtol 1e-10) in
    ``tests/golden/bilinear_n51_seed42.npz``.

    Every lane of :func:`make_batched_bilinear_problems` poses the same
    problem from a different start (per-lane data is the initial guess;
    bounds, pins and objective are shared), so one optimum covers all
    lanes. RMS < 1e-4 is the reference's cross-solver agreement bar
    (upstream `test/solver_test_utils.jl:105-132`).
    """
    data = np.load(_GOLDEN)
    Zg = np.asarray(data["Z_star"], dtype=np.float64)
    layout = res.problem.trajectory.layout
    d = layout.dim
    u_g = Zg[: int(data["N"]) * d].reshape(-1, d)[:, layout.comp_slice("u")]
    u = np.asarray(res.problem.trajectory.data["u"], dtype=np.float64)
    return np.sqrt(np.mean((u - u_g[None]) ** 2, axis=(1, 2)))


def rms_u_vs_golden(res, n_lanes: int | None = None) -> float:
    """Max of :func:`rms_u_per_lane` over the first ``n_lanes`` lanes."""
    return float(rms_u_per_lane(res)[:n_lanes].max())
