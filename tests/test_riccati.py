"""Riccati KKT backend vs dense backend: operator-level and end-to-end
agreement. This is the correctness anchor for the batched performance path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import directtrajopt_tpu as dtx
from directtrajopt_tpu.solvers import make_nlp
from directtrajopt_tpu.solvers.ops_dense import DenseOps
from directtrajopt_tpu.solvers.ops_riccati import RiccatiOps, analyze

G_DRIFT = np.array([[0.0, 1.0], [-1.0, 0.0]])
G_DRIVE = np.array([[0.0, 1.0], [1.0, 0.0]])


def make_problem(
    free_time=True,
    with_l1=True,
    with_nl_ineq=True,
    with_nl_eq=True,
    with_symmetry=True,
    with_duration=True,
    with_globals=False,
    with_border_ineq=False,
    N=9,
    seed=0,
):
    rng = np.random.default_rng(seed)
    data = {
        "x": 0.4 * rng.normal(size=(N, 2)),
        "u": 0.3 * rng.normal(size=(N, 1)),
        "du": 0.2 * rng.normal(size=(N, 1)),
        "ddu": 0.2 * rng.normal(size=(N, 1)),
    }
    if with_l1:
        data["sl"] = 0.3 + 0.1 * rng.random((N, 1))
    if free_time:
        data["dt"] = 0.1 + 0.02 * rng.random((N, 1))
    bounds = {"u": 0.9}
    if with_l1:
        bounds["sl"] = (0.0, np.inf)
    if free_time:
        bounds["dt"] = (0.02, 0.4)
    if with_globals:
        bounds["theta"] = 2.0
    traj = dtx.Trajectory.create(
        data,
        timestep="dt" if free_time else 0.1,
        controls=("u", "ddu"),
        initial={"x": [1.0, 0.0], "u": [0.0]},
        final={"x": [0.0, 1.0], "u": [0.0]},
        bounds=bounds,
        global_data={"theta": 0.3 * rng.normal(size=2) + 0.5}
        if with_globals
        else None,
    )
    integs = [
        dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", traj),
        dtx.DerivativeIntegrator.create("u", "du", traj),
        dtx.DerivativeIntegrator.create("du", "ddu", traj),
    ]
    obj = (
        dtx.QuadraticRegularizer.create("u", traj, 1.0)
        + 1e-2 * dtx.QuadraticRegularizer.create("ddu", traj, 1.0)
    )
    if free_time:
        obj = obj + 0.3 * dtx.MinimumTimeObjective.create(traj, 1.0)
    cons = []
    if with_l1:
        cons.append(dtx.L1SlackConstraint.create("du", "sl", traj))
    if with_nl_ineq:
        cons.append(
            dtx.NonlinearKnotPointConstraint.create(
                lambda x: jnp.array([jnp.sum(x**2) - 2.5]), "x", traj, equality=False
            )
        )
    if with_nl_eq:
        cons.append(
            dtx.NonlinearKnotPointConstraint.create(
                lambda u: jnp.array([u[0] ** 3 - 0.001]), "u", traj, times=[3]
            )
        )
    if with_symmetry:
        cons.append(dtx.SymmetryConstraint.create("ddu", [0], even=True))
    if with_duration and free_time:
        cons.append(dtx.DurationConstraint(0.1 * (N - 1)))
    if with_globals:
        # arrowhead coverage: global objective (pure + knot-coupled Hessian
        # cross blocks), a pure-global nonlinear equality, a global-coupled
        # knot equality, and a linear equality row with global columns
        obj = obj + dtx.GlobalObjective.create(
            lambda th: jnp.sum(th**2) + 0.1 * jnp.sum(th**4), "theta", traj
        )
        obj = obj + dtx.GlobalKnotPointObjective.create(
            lambda v: 0.05 * (v[0] * v[-1]) ** 2, "x", "theta", traj
        )
        cons.append(
            dtx.NonlinearGlobalConstraint.create(
                lambda th: jnp.array([jnp.sum(th**2) - 0.5]), "theta", traj
            )
        )
        cons.append(
            dtx.NonlinearGlobalKnotPointConstraint.create(
                lambda v: jnp.array([v[0] + 0.2 * v[-1] ** 2 - 0.1]),
                "u",
                "theta",
                traj,
                times=[2],
            )
        )
        cons.append(
            dtx.GlobalLinearConstraint.create(
                "theta", np.array([[1.0, -0.5]]), lb=[0.1], ub=[0.1]
            )
        )
    if with_border_ineq:
        # multi-knot linear inequality rows: a duration RANGE (Σdt within
        # [lb, ub] — two border rows) when time is free, else a total-u range
        if free_time:
            cons.append(
                dtx.DurationConstraint(lb=0.05 * (N - 1), ub=0.2 * (N - 1))
            )
        else:
            cons.append(dtx.TotalConstraint.create("u", lb=-2.0, ub=2.0))
        if with_globals:
            # global-coupled nonlinear inequality (knot + global columns)
            cons.append(
                dtx.NonlinearGlobalKnotPointConstraint.create(
                    lambda v: jnp.array([v[0] ** 2 + 0.3 * v[-1] - 1.2]),
                    "x",
                    "theta",
                    traj,
                    times=[1, 4],
                    equality=False,
                )
            )
            # pure-global nonlinear inequality
            cons.append(
                dtx.NonlinearGlobalConstraint.create(
                    lambda th: jnp.array([jnp.sum(th**2) - 1.8]),
                    "theta",
                    traj,
                    equality=False,
                )
            )
            # pure-global linear inequality rows (range → two rows)
            cons.append(
                dtx.GlobalLinearConstraint.create(
                    "theta", np.array([[0.7, 1.0]]), lb=[-1.5], ub=[1.5]
                )
            )
    return dtx.DirectTrajOptProblem.create(traj, obj, integs, constraints=cons)


def _compare_ops(prob, seed=1, atol=1e-6):
    nlp = make_nlp(prob)
    assert analyze(nlp) is not None, "fixture should be Riccati-eligible"
    dense = DenseOps(nlp)
    ricc = RiccatiOps(nlp)

    rng = np.random.default_rng(seed)
    Z = nlp.apply_pins(prob.trajectory.to_zvec())
    lam = jnp.asarray(rng.normal(size=nlp.n_eq))
    nu = jnp.asarray(np.abs(rng.normal(size=nlp.n_in)) + 0.1)

    ve = jnp.asarray(rng.normal(size=nlp.n_eq))
    vi = jnp.asarray(rng.normal(size=nlp.n_in))
    vz = jnp.asarray(rng.normal(size=nlp.z_dim))

    from directtrajopt_tpu.solvers.options import IPMOptions

    opt = IPMOptions().astype(jnp.float64)
    Sig = jnp.asarray(np.abs(rng.normal(size=nlp.z_dim)) + 3.0) * nlp.free_mask
    D = jnp.asarray(np.abs(rng.normal(size=nlp.n_in)) + 0.5)
    g_hat = jnp.asarray(rng.normal(size=nlp.z_dim)) * nlp.free_mask
    w_rhs = jnp.asarray(rng.normal(size=nlp.z_dim))
    g2 = jnp.asarray(rng.normal(size=nlp.z_dim)) * nlp.free_mask
    w2 = jnp.asarray(rng.normal(size=nlp.z_dim))

    # the whole pipeline runs inside ONE jit: eagerly, the hundreds of small
    # ops in prepare/kkt_step dominate suite wall time via Python dispatch
    def run():
        dctx = dense.prepare(Z, lam, nu)
        rctx = ricc.prepare(Z, lam, nu)
        Jm = dctx._Je * nlp.free_mask[None, :]
        rhs_c = Jm @ w_rhs
        c2 = Jm @ w2
        dZ_d, lam_d, ok_d, delta_d, _ = dctx.kkt_step(
            Sig, D, g_hat, rhs_c, jnp.zeros(()), opt
        )
        dZ_r, lam_r, ok_r, delta_r, resolve_r = rctx.kkt_step(
            Sig, D, g_hat, rhs_c, jnp.zeros(()), opt
        )
        dZ_r2, lam_r2 = resolve_r(-g2, c2)
        # fused multi-RHS resolve must match per-rhs resolves exactly
        dZ_m, lam_m = resolve_r.many(
            jnp.stack([-g2, -g_hat]), jnp.stack([c2, rhs_c])
        )
        return dict(
            rc_e=rctx.c_e, dc_e=dctx.c_e, rc_i=rctx.c_i, dc_i=dctx.c_i,
            rgf=rctx.grad_f, dgf=dctx.grad_f,
            rJeT=rctx.JeT(ve), dJeT=dctx.JeT(ve),
            rJiT=rctx.JiT(vi), dJiT=dctx.JiT(vi),
            rJi=rctx.Ji(vz), dJi=dctx.Ji(vz),
            W=dctx._W, Je=dctx._Je, Ji=dctx._Ji, rhs_c=rhs_c, c2=c2,
            dZ_d=dZ_d, lam_d=lam_d, ok_d=ok_d, delta_d=delta_d,
            dZ_r=dZ_r, lam_r=lam_r, ok_r=ok_r, delta_r=delta_r,
            dZ_r2=dZ_r2, lam_r2=lam_r2, dZ_m=dZ_m, lam_m=lam_m,
        )

    o = {k: np.asarray(v) for k, v in jax.jit(run)().items()}

    np.testing.assert_allclose(o["rc_e"], o["dc_e"], atol=1e-12)
    np.testing.assert_allclose(o["rc_i"], o["dc_i"], atol=1e-12)
    np.testing.assert_allclose(o["rgf"], o["dgf"], atol=1e-12)
    np.testing.assert_allclose(o["rJeT"], o["dJeT"], atol=1e-10)
    np.testing.assert_allclose(o["rJiT"], o["dJiT"], atol=1e-10)
    np.testing.assert_allclose(o["rJi"], o["dJi"], atol=1e-10)

    assert bool(o["ok_d"]) and bool(o["ok_r"])
    assert float(o["delta_d"]) == 0.0 and float(o["delta_r"]) == 0.0

    # ground truth: the Riccati solution must satisfy the exact (dense) KKT
    # equations — this is stronger than comparing against the dense solution,
    # which carries its own δc perturbation amplified by near-dependent rows.
    f = np.asarray(nlp.free_mask)
    H = o["W"] + np.diag(np.asarray(Sig))
    Jim = o["Ji"] * f[None, :]
    if nlp.n_in:
        H = H + (Jim.T * np.asarray(D)[None, :]) @ Jim
    Hm = f[:, None] * f[None, :] * H + np.diag(1 - f)
    Jm_np = o["Je"] * f[None, :]

    def kkt_residuals(dZ, lm, g, rc):
        r_stat = Hm @ dZ + Jm_np.T @ lm + np.asarray(g)
        r_cons = Jm_np @ dZ - np.asarray(rc)
        return np.max(np.abs(r_stat)), np.max(np.abs(r_cons))

    stat_r, cons_r = kkt_residuals(o["dZ_r"], o["lam_r"], g_hat, o["rhs_c"])
    scale = max(1.0, float(np.max(np.abs(o["dZ_r"]))), float(np.max(np.abs(o["lam_r"]))))
    assert stat_r < 1e-8 * scale, f"Riccati stationarity residual {stat_r} (scale {scale})"
    assert cons_r < 1e-7 * scale, f"Riccati constraint residual {cons_r} (scale {scale})"
    # primal steps agree (looser: δc/conditioning differences are expected)
    np.testing.assert_allclose(o["dZ_r"], o["dZ_d"], atol=1e-3 * scale)

    # resolve (second rhs through the same factorization)
    stat2, cons2 = kkt_residuals(o["dZ_r2"], o["lam_r2"], g2, o["c2"])
    scale2 = max(1.0, float(np.max(np.abs(o["dZ_r2"]))), float(np.max(np.abs(o["lam_r2"]))))
    assert stat2 < 1e-8 * scale2
    assert cons2 < 1e-7 * scale2

    # fused multi-RHS resolve == per-rhs resolves
    np.testing.assert_allclose(o["dZ_m"][0], o["dZ_r2"], atol=1e-10 * scale2)
    np.testing.assert_allclose(o["lam_m"][0], o["lam_r2"], atol=1e-10 * scale2)
    np.testing.assert_allclose(o["dZ_m"][1], o["dZ_r"], atol=1e-9 * scale)
    np.testing.assert_allclose(o["lam_m"][1], o["lam_r"], atol=1e-9 * scale)


def test_ops_agree_full_zoo():
    _compare_ops(make_problem())


def test_ops_agree_globals():
    """Arrowhead border: global objective + global-coupled equality zoo."""
    _compare_ops(
        make_problem(
            with_l1=False,
            with_nl_ineq=False,
            with_symmetry=False,
            with_duration=False,
            with_globals=True,
        )
    )


def test_ops_agree_globals_full():
    """Arrowhead combined with the full constraint zoo (m_c > 0 coupling)."""
    _compare_ops(make_problem(with_globals=True))


def test_ops_agree_fixed_time_minimal():
    _compare_ops(
        make_problem(
            free_time=False,
            with_l1=False,
            with_nl_ineq=False,
            with_nl_eq=False,
            with_symmetry=False,
            with_duration=False,
        )
    )


def test_ops_agree_no_inequalities():
    _compare_ops(
        make_problem(with_l1=False, with_nl_ineq=False, with_duration=True)
    )


def test_ops_agree_border_ineq():
    """Multi-knot linear inequality rows (duration range) ride the Schur
    border with the exact −1/D diagonal — no dense fallback, no globals."""
    _compare_ops(make_problem(with_border_ineq=True))


def test_ops_agree_border_ineq_globals():
    """Border inequalities composed with the arrowhead: global-coupled and
    pure-global nonlinear inequalities + global linear inequality rows."""
    _compare_ops(make_problem(with_border_ineq=True, with_globals=True))


def test_eligibility():
    # globals -> eligible since round 2 (arrowhead border)
    N = 5
    traj = dtx.Trajectory.create(
        {"x": np.zeros((N, 1)), "v": np.zeros((N, 1))},
        timestep=0.1,
        global_data={"th": [0.1]},
    )
    prob = dtx.DirectTrajOptProblem.create(
        traj,
        dtx.QuadraticRegularizer.create("v", traj, 1.0),
        dtx.DerivativeIntegrator.create("x", "v", traj),
    )
    assert analyze(make_nlp(prob)) is not None
    # global-coupled INEQUALITY -> eligible since round 3 (border ineq rows)
    prob_gi = dtx.DirectTrajOptProblem.create(
        traj,
        dtx.QuadraticRegularizer.create("v", traj, 1.0),
        dtx.DerivativeIntegrator.create("x", "v", traj),
        constraints=[
            dtx.NonlinearGlobalKnotPointConstraint.create(
                lambda w: jnp.array([w[0] * w[-1] - 1.0]),
                "x",
                "th",
                traj,
                equality=False,
            )
        ],
    )
    S_gi = analyze(make_nlp(prob_gi))
    assert S_gi is not None and len(S_gi.ib_flat) == N
    # plain OCP -> eligible
    traj2 = dtx.Trajectory.create(
        {"x": np.zeros((N, 1)), "v": np.zeros((N, 1))}, timestep=0.1
    )
    prob2 = dtx.DirectTrajOptProblem.create(
        traj2,
        dtx.QuadraticRegularizer.create("v", traj2, 1.0),
        dtx.DerivativeIntegrator.create("x", "v", traj2),
    )
    assert analyze(make_nlp(prob2)) is not None


def test_e2e_riccati_matches_dense():
    """Feasible-by-construction problem with bounds + L1 slacks + free time:
    both backends must converge to the same point."""
    rng = np.random.default_rng(2)
    N = 14
    integ = dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", None)
    u = 0.25 * np.sin(np.linspace(0, 5, N))[:, None]
    xs = dtx.bilinear_rollout(integ, jnp.array([1.0, 0.0]), jnp.asarray(u), 0.12)
    data = {
        "x": np.asarray(xs) + 0.02 * rng.normal(size=(N, 2)),
        "u": u,
        "du": np.zeros((N, 1)),
        "sl": 0.2 * np.ones((N, 1)),
        "dt": np.full((N, 1), 0.12),
    }
    traj = dtx.Trajectory.create(
        data,
        timestep="dt",
        controls=("u", "du"),
        initial={"x": [1.0, 0.0]},
        final={"x": np.asarray(xs[-1])},
        bounds={"u": 0.8, "sl": (0.0, np.inf), "dt": (0.05, 0.3)},
    )
    integs = [
        dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", traj),
        dtx.DerivativeIntegrator.create("u", "du", traj),
    ]
    obj = (
        dtx.QuadraticRegularizer.create("u", traj, 1.0)
        + 0.1 * dtx.LinearRegularizer.create("sl", traj, 1.0)
        + 0.05 * dtx.MinimumTimeObjective.create(traj, 1.0)
    )
    cons = [dtx.L1SlackConstraint.create("du", "sl", traj)]
    prob = dtx.DirectTrajOptProblem.create(traj, obj, integs, constraints=cons)
    # NOTE: at the L1 solution (du=0, sl=0) both slack rows and the sl bound
    # are active — LICQ fails, so the dual error has a floor ~1e-5 (Ipopt
    # shows the same on degenerate problems); acceptable-level convergence is
    # the right bar here.
    kw = dict(max_iter=300, tol=1e-8, acceptable_tol=1e-4, acceptable_iter=10)
    res_d = dtx.solve(prob, backend="dense", **kw)
    res_r = dtx.solve(prob, backend="riccati", **kw)
    assert bool(res_d.converged), f"dense failed: kkt={float(res_d.kkt_error)}"
    assert bool(res_r.converged), f"riccati failed: kkt={float(res_r.kkt_error)}"
    # the L1+min-time valley is flat, so compare objectives, not iterates
    # (both stop at acceptable level; a few 1e-3 relative is the flatness)
    np.testing.assert_allclose(
        float(res_r.objective), float(res_d.objective), rtol=5e-3
    )


def test_e2e_riccati_matches_dense_strict():
    """Non-degenerate bounded problem: backends agree point-to-point."""
    rng = np.random.default_rng(4)
    N = 16
    integ = dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", None)
    u = 0.3 * np.sin(np.linspace(0, 5, N))[:, None]
    xs = dtx.bilinear_rollout(integ, jnp.array([1.0, 0.0]), jnp.asarray(u), 0.12)
    traj = dtx.Trajectory.create(
        {"x": np.asarray(xs) + 0.03 * rng.normal(size=(N, 2)), "u": u},
        timestep=0.12,
        controls="u",
        initial={"x": [1.0, 0.0]},
        final={"x": np.asarray(xs[-1])},
        bounds={"u": 0.5},
    )
    prob = dtx.DirectTrajOptProblem.create(
        traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), integ
    )
    res_d = dtx.solve(prob, backend="dense", max_iter=200)
    res_r = dtx.solve(prob, backend="riccati", max_iter=200)
    assert bool(res_d.converged) and bool(res_r.converged)
    assert float(res_d.kkt_error) < 1e-8 and float(res_r.kkt_error) < 1e-8
    np.testing.assert_allclose(
        np.asarray(res_r.ipm.Z), np.asarray(res_d.ipm.Z), atol=1e-6
    )


def test_e2e_riccati_matches_dense_globals():
    """Arrowhead E2E: a global phase parameter coupled to the trajectory
    through a knot equality and a global objective — both backends must find
    the same point (analog of `src/objectives/global_objectives.jl:151-341`
    coverage)."""
    rng = np.random.default_rng(7)
    N = 12
    integ = dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", None)
    u = 0.3 * np.sin(np.linspace(0, 4, N))[:, None]
    xs = dtx.bilinear_rollout(integ, jnp.array([1.0, 0.0]), jnp.asarray(u), 0.12)
    traj = dtx.Trajectory.create(
        {"x": np.asarray(xs) + 0.02 * rng.normal(size=(N, 2)), "u": u},
        timestep=0.12,
        controls="u",
        initial={"x": [1.0, 0.0]},
        final={"x": np.asarray(xs[-1])},
        bounds={"u": 0.8, "theta": 3.0},
        global_data={"theta": [0.4, -0.2]},
    )
    obj = (
        dtx.QuadraticRegularizer.create("u", traj, 1.0)
        + dtx.GlobalObjective.create(
            lambda th: jnp.sum((th - 0.3) ** 2), "theta", traj
        )
        + dtx.GlobalKnotPointObjective.create(
            lambda v: 0.02 * (v[1] - v[-1]) ** 2, "x", "theta", traj
        )
    )
    cons = [
        dtx.NonlinearGlobalKnotPointConstraint.create(
            lambda v: jnp.array([v[0] - 0.5 * v[-2] - 0.1]),
            "u",
            "theta",
            traj,
            times=[3],
        ),
        dtx.GlobalLinearConstraint.create(
            "theta", np.array([[1.0, 1.0]]), lb=[0.2], ub=[0.2]
        ),
    ]
    prob = dtx.DirectTrajOptProblem.create(
        traj,
        obj,
        [dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", traj)],
        constraints=cons,
    )
    from directtrajopt_tpu.solvers.canonical import make_nlp as _mk

    assert analyze(_mk(prob)) is not None, "global fixture should be eligible"
    res_d = dtx.solve(prob, backend="dense", max_iter=200)
    res_r = dtx.solve(prob, backend="riccati", max_iter=200)
    assert bool(res_d.converged) and bool(res_r.converged)
    assert float(res_d.kkt_error) < 1e-7 and float(res_r.kkt_error) < 1e-7
    np.testing.assert_allclose(
        np.asarray(res_r.ipm.Z), np.asarray(res_d.ipm.Z), atol=1e-5
    )


def test_e2e_riccati_border_ineq_binding():
    """E2E with a BINDING duration upper bound (multi-knot linear inequality
    on the border): both backends converge to the same point, and the bound
    is active — a free-time minimum-energy problem wants long durations, so
    Σdt must land on ub."""
    rng = np.random.default_rng(11)
    N = 12
    integ = dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", None)
    u = 0.3 * np.sin(np.linspace(0, 4, N))[:, None]
    xs = dtx.bilinear_rollout(integ, jnp.array([1.0, 0.0]), jnp.asarray(u), 0.12)
    traj = dtx.Trajectory.create(
        {
            "x": np.asarray(xs) + 0.01 * rng.normal(size=(N, 2)),
            "u": u,
            "dt": np.full((N, 1), 0.12),
        },
        timestep="dt",
        controls="u",
        initial={"x": [1.0, 0.0]},
        final={"x": np.asarray(xs[-1])},
        bounds={"u": 0.8, "dt": (0.02, 0.5)},
    )
    # pure energy objective (no time cost): the unconstrained optimum sits
    # at Σdt ≈ 1.22 here, so a cap at 0.1·(N−1) = 1.1 binds
    obj = dtx.QuadraticRegularizer.create("u", traj, 1.0)
    ub = 0.10 * (N - 1)
    cons = [dtx.DurationConstraint(lb=0.02 * (N - 1), ub=ub)]
    prob = dtx.DirectTrajOptProblem.create(
        traj,
        obj,
        [dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", traj)],
        constraints=cons,
    )
    from directtrajopt_tpu.solvers.canonical import make_nlp as _mk

    S = analyze(_mk(prob))
    assert S is not None and len(S.ib_flat) == 2, "duration range → 2 border rows"
    res_d = dtx.solve(prob, backend="dense", max_iter=200)
    res_r = dtx.solve(prob, backend="riccati", max_iter=200)
    assert bool(res_d.converged) and bool(res_r.converged)
    assert float(res_d.kkt_error) < 1e-7 and float(res_r.kkt_error) < 1e-7
    np.testing.assert_allclose(
        np.asarray(res_r.ipm.Z), np.asarray(res_d.ipm.Z), atol=1e-5
    )
    dur = float(np.sum(np.asarray(res_r.problem.trajectory.data["dt"])[:-1]))
    assert abs(dur - ub) < 1e-5, f"duration cap should bind: {dur} vs {ub}"


def test_e2e_riccati_simple_bilinear():
    rng = np.random.default_rng(0)
    N = 20
    integ = dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", None)
    u = 0.3 * np.sin(np.linspace(0, 6, N))[:, None]
    xs = dtx.bilinear_rollout(integ, jnp.array([1.0, 0.0]), jnp.asarray(u), 0.15)
    traj = dtx.Trajectory.create(
        {"x": np.asarray(xs) + 0.05 * rng.normal(size=(N, 2)), "u": u},
        timestep=0.15,
        controls="u",
        initial={"x": [1.0, 0.0]},
        final={"x": np.asarray(xs[-1])},
    )
    prob = dtx.DirectTrajOptProblem.create(
        traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), integ
    )
    res = dtx.solve(prob, backend="riccati", max_iter=100)
    assert bool(res.converged)
    assert float(res.kkt_error) < 1e-8
