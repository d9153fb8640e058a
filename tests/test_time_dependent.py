"""TimeDependentBilinearIntegrator + GeneralIntegrator tests, mirroring the
reference's testitems (`time_dependent_bilinear_integrator.jl:248-269` — which
itself only requires loose agreement through the ODE solve)."""

import jax.numpy as jnp
import numpy as np
import scipy.linalg

import directtrajopt_tpu as dtx
from directtrajopt_tpu.integrators import stack_residuals
from directtrajopt_tpu.solvers import make_nlp
from directtrajopt_tpu.solvers.ops_riccati import analyze
from directtrajopt_tpu.utils.testing import check_integrator

G_DRIFT = np.array([[0.0, 1.0], [-1.0, 0.0]])
G_DRIVE = np.array([[0.0, 1.0], [1.0, 0.0]])


def td_traj(N=8, seed=0):
    rng = np.random.default_rng(seed)
    dts = np.full((N, 1), 0.1)
    return dtx.Trajectory.create(
        {
            "x": rng.normal(size=(N, 2)) * 0.5,
            "u": rng.normal(size=(N, 1)) * 0.3,
            "t": np.cumsum(dts, axis=0) - 0.1,
            "dt": dts,
        },
        timestep="dt",
        controls="u",
    )


def test_td_matches_bilinear_when_time_independent():
    """With G independent of t and ZOH control, the ODE solve must agree with
    the exact matrix exponential."""
    traj = td_traj()
    G = lambda u, t: jnp.asarray(G_DRIFT) + u[0] * jnp.asarray(G_DRIVE)
    td = dtx.TimeDependentBilinearIntegrator.create(
        G, "x", "u", "t", traj, spline_order=0, n_steps=20
    )
    res = np.asarray(stack_residuals(td, traj.layout, traj.knot_matrix()))
    for k in range(traj.N - 1):
        u = float(traj.data["u"][k, 0])
        expect = np.asarray(traj.data["x"][k + 1]) - scipy.linalg.expm(
            0.1 * (G_DRIFT + u * G_DRIVE)
        ) @ np.asarray(traj.data["x"][k])
        np.testing.assert_allclose(res[k], expect, atol=1e-9)


def test_td_time_dependence_and_derivatives():
    traj = td_traj()
    G = lambda u, t: (1.0 + 0.3 * jnp.sin(t)) * jnp.asarray(G_DRIFT) + u[0] * jnp.asarray(
        G_DRIVE
    )
    for order in (0, 1):
        td = dtx.TimeDependentBilinearIntegrator.create(
            G, "x", "u", "t", traj, spline_order=order, n_steps=8
        )
        check_integrator(td, traj, atol=1e-4, hessian_atol=1e-3)


def test_td_riccati_eligibility():
    traj = td_traj()
    G = lambda u, t: jnp.asarray(G_DRIFT) + u[0] * jnp.asarray(G_DRIVE)
    obj = dtx.QuadraticRegularizer.create("u", traj, 1.0)
    for order, eligible in [(0, True), (1, False)]:
        td = dtx.TimeDependentBilinearIntegrator.create(
            G, "x", "u", "t", traj, spline_order=order
        )
        prob = dtx.DirectTrajOptProblem.create(traj, obj, td)
        assert (analyze(make_nlp(prob)) is not None) == eligible


def test_general_integrator_pendulum():
    """Pendulum reach with RK4 general dynamics, feasible by rollout."""
    N = 25
    dt = 0.1

    def f(x, u):
        return jnp.array([x[1], u[0] - jnp.sin(x[0])])

    integ = dtx.GeneralIntegrator.create(f, "x", "u")
    # roll out a control profile to build a feasible goal
    u_prof = 0.4 * np.sin(np.linspace(0, 3, N))[:, None]
    x = np.zeros((N, 2))
    x[0] = [0.5, 0.0]
    lay_probe = None
    from directtrajopt_tpu.integrators.time_dependent import rk4_step

    for k in range(N - 1):
        x[k + 1] = np.asarray(
            rk4_step(lambda x_, u_: f(x_, u_), jnp.asarray(x[k]), dt, jnp.asarray(u_prof[k]))
        )
    traj = dtx.Trajectory.create(
        {"x": x, "u": u_prof},
        timestep=dt,
        controls="u",
        initial={"x": x[0]},
        final={"x": x[-1]},
        bounds={"u": 1.0},
    )
    check_integrator(integ, traj, atol=1e-5, hessian_atol=1e-3)
    prob = dtx.DirectTrajOptProblem.create(
        traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), integ
    )
    res = dtx.solve(prob, max_iter=200)
    assert bool(res.converged)
    assert float(res.kkt_error) < 1e-7
    xN = np.asarray(res.problem.trajectory.data["x"][-1])
    np.testing.assert_allclose(xN, x[-1], atol=1e-6)


def test_general_integrator_euler():
    def f(x, u):
        return jnp.array([u[0]])

    integ = dtx.GeneralIntegrator.create(f, "x", "u", scheme="euler")
    N = 6
    traj = dtx.Trajectory.create(
        {"x": np.zeros((N, 1)), "u": np.ones((N, 1))}, timestep=0.5
    )
    res = np.asarray(stack_residuals(integ, traj.layout, traj.knot_matrix()))
    np.testing.assert_allclose(res, -0.5, atol=1e-12)  # x_{k+1} - x_k - dt*u


def test_td_order1_riccati_via_substitution():
    """Spline-order-1 TD dynamics (the reference's default,
    `time_dependent_bilinear_integrator.jl:161-163`) become Riccati-eligible
    when a derivative chain determines u_{k+1} from z_k: the lowering pass
    substitutes u_{k+1} = u_k + Δt·du_k into the residual (exact within the
    chain's feasible set). Solutions must agree with the dense backend on the
    un-lowered problem, and the solution must satisfy the ORIGINAL order-1
    residuals."""
    N = 10
    rng = np.random.default_rng(3)
    dts = np.full((N, 1), 0.1)
    traj = dtx.Trajectory.create(
        {
            "x": rng.normal(size=(N, 2)) * 0.5,
            "u": rng.normal(size=(N, 1)) * 0.3,
            "du": rng.normal(size=(N, 1)) * 0.1,
            "t": np.cumsum(dts, axis=0) - 0.1,
            "dt": dts,
        },
        timestep="dt",
        controls="du",
        initial={"x": [1.0, 0.0], "t": [0.0]},
        bounds={"dt": (0.05, 0.2)},
    )
    G = lambda u, t: (1.0 + 0.2 * jnp.sin(t)) * jnp.asarray(G_DRIFT) + u[
        0
    ] * jnp.asarray(G_DRIVE)
    td = dtx.TimeDependentBilinearIntegrator.create(
        G, "x", "u", "t", traj, spline_order=1, n_steps=6
    )
    chain = dtx.DerivativeIntegrator.create("u", "du", traj)
    obj = dtx.QuadraticRegularizer.create(
        "u", traj, 1.0
    ) + dtx.QuadraticRegularizer.create("du", traj, 0.1)
    tc = dtx.TimeConsistencyConstraint(time_name="t")
    prob = dtx.DirectTrajOptProblem.create(
        traj, obj, [td, chain], constraints=[tc]
    )

    # the lowering makes the order-1 problem Riccati-eligible
    from directtrajopt_tpu.solvers.solve import _lower_order1_td

    lowered = _lower_order1_td(prob)
    assert analyze(make_nlp(lowered)) is not None
    assert analyze(make_nlp(prob)) is None  # unlowered still isn't

    res_r = dtx.solve(prob, backend="riccati", tol=1e-10, max_iter=200)
    assert bool(res_r.converged)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # dense-cliff warning is expected
        res_d = dtx.solve(prob, backend="dense", tol=1e-10, max_iter=200)
    assert bool(res_d.converged)
    # agreement: the free-time problem has near-flat directions, so compare
    # objective values (tight) and primal iterates (loose), not bitwise Z
    np.testing.assert_allclose(
        float(res_r.objective), float(res_d.objective), rtol=1e-7, atol=1e-10
    )
    Zr = np.asarray(res_r.problem.trajectory.to_zvec())
    Zd = np.asarray(res_d.problem.trajectory.to_zvec())
    np.testing.assert_allclose(Zr, Zd, atol=5e-3)

    # the Riccati solution satisfies the ORIGINAL (un-substituted) residuals
    res_orig = np.asarray(
        stack_residuals(td, traj.layout, res_r.problem.trajectory.knot_matrix())
    )
    assert np.max(np.abs(res_orig)) < 1e-8

    # the returned problem carries the ORIGINAL integrators (no closure leak)
    assert res_r.problem.integrators[0].u_next_fn is None


def test_td_error_estimate_and_n_steps_tuning():
    """Step-doubling error control for the fixed-step TD integrator.

    The reference integrates adaptively under tolerances
    (`time_dependent_bilinear_integrator.jl:70-132`) and its own tests
    accept atol=1e-3 agreement (`:248-269`). The static-shape analog is a
    static ``n_steps`` chosen/validated against that bar: this test
    DOCUMENTS a problem class (fast-oscillating G with ~10 carrier periods
    per knot interval) where the default n_steps=10 silently
    under-integrates, and asserts the tuner detects it and fixes it."""
    from directtrajopt_tpu.integrators import td_integration_error, tune_n_steps

    N, nu = 6, 60.0  # dt=1.0 per knot, carrier frequency nu => nu*h = 6 at n=10
    rng = np.random.default_rng(3)
    dts = np.full((N, 1), 1.0)
    traj = dtx.Trajectory.create(
        {
            "x": rng.normal(size=(N, 2)) * 0.5,
            "u": rng.normal(size=(N, 1)) * 0.5,
            "t": np.cumsum(dts, axis=0) - 1.0,
            "dt": dts,
        },
        timestep="dt",
        controls="u",
    )
    G = lambda u, t: (jnp.sin(nu * t) + u[0]) * jnp.asarray(G_DRIFT)
    td = dtx.TimeDependentBilinearIntegrator.create(
        G, "x", "u", "t", traj, spline_order=0, n_steps=10
    )
    layout = traj.layout
    zmat = traj.knot_matrix()

    # the documented failure: the default n_steps misses the 1e-3 bar
    err10 = float(np.max(np.asarray(td_integration_error(td, layout, zmat))))
    assert err10 > 1e-3, f"problem class no longer under-integrates: {err10}"

    tuned, est = tune_n_steps(td, traj, atol=1e-3)
    assert tuned.n_steps > 10 and est <= 1e-3

    # the estimate is honest: against a 512-step "exact" integration the
    # tuned residual lands within the requested band (x ~ O(1), unit-norm
    # generator => absolute error ~ local truncation error)
    exact = td.replace(n_steps=512)
    r_tuned = np.asarray(stack_residuals(tuned, layout, zmat))
    r_exact = np.asarray(stack_residuals(exact, layout, zmat))
    assert np.max(np.abs(r_tuned - r_exact)) < 5e-3
    # and the default-n_steps residual genuinely violates it
    r_10 = np.asarray(stack_residuals(td, layout, zmat))
    assert np.max(np.abs(r_10 - r_exact)) > 1e-3


def test_td_accuracy_guard_at_solution():
    """In-solve TD accuracy guard (VERDICT r4 missing #1): ``n_steps`` is
    tuned at the INITIAL trajectory; when the optimizer moves the controls
    into a stiffer regime, the step-doubling estimate re-evaluated at the
    solution (SolveResult.td_error) must flag it and solve() must warn —
    the detection analog of the reference's adaptive in-solve integration
    (`time_dependent_bilinear_integrator.jl:70-132`)."""
    import warnings

    N = 6
    dts = np.full((N, 1), 0.5)
    rng = np.random.default_rng(0)
    traj = dtx.Trajectory.create(
        {
            "x": rng.normal(size=(N, 2)) * 0.5,
            "u": np.full((N, 1), 0.05),
            "t": np.cumsum(dts, axis=0) - 0.5,
            "dt": dts,
        },
        timestep="dt",
        controls="u",
    )
    # stiffness rises steeply with |u|: benign at the initial u=0.05
    # (estimate 2e-7), under-integrated once u is pushed to 3 (7e-2).
    # n_steps=6 keeps the unrolled RK4 chain (and its compile) small.
    G = lambda u, t: (
        (0.3 + 4.0 * u[0] ** 2) * jnp.sin(8.0 * t) * jnp.asarray(G_DRIFT)
    )
    td = dtx.TimeDependentBilinearIntegrator.create(
        G, "x", "u", "t", traj, spline_order=0, n_steps=6
    )
    from directtrajopt_tpu.integrators import td_integration_error

    e_init = float(
        np.max(np.asarray(td_integration_error(td, traj.layout, traj.knot_matrix())))
    )
    assert e_init < 1e-3, f"setup broke: initial traj already stiff ({e_init})"

    # the solve drives u to 3 (per-knot equality), entering the stiff regime
    prob = dtx.DirectTrajOptProblem.create(
        traj,
        dtx.QuadraticRegularizer.create("u", traj, 1e-3),
        td,
        constraints=[dtx.EqualityConstraint.create("u", range(N), 3.0)],
    )
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = dtx.solve(prob, max_iter=100)
    assert res.td_error is not None
    e_sol = float(np.max(np.asarray(res.td_error)))
    assert e_sol > 1e-3, f"solution should be under-integrated, got {e_sol}"
    assert any("integration-error" in str(x.message) or "integrator error" in str(x.message) for x in w), [str(x.message) for x in w]

    # control: a benign solve raises no TD warning and reports a small flag
    prob_ok = dtx.DirectTrajOptProblem.create(
        traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), td
    )
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        res_ok = dtx.solve(prob_ok, max_iter=100)
    assert float(np.max(np.asarray(res_ok.td_error))) <= 1e-3
    assert not any("integrator error" in str(x.message) for x in w2)
