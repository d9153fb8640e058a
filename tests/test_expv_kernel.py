"""Closed-form bilinear window Jacobians and residuals (ops/expv_kernel.py)
vs generic window AD — the correctness anchor for the prepare-stage fast
path and the line search's residuals."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import directtrajopt_tpu as dtx
from directtrajopt_tpu.integrators.base import stack_jacobians_zk
from directtrajopt_tpu.ops import expv_kernel
from directtrajopt_tpu.ops.expm import expv_taylor
from directtrajopt_tpu.ops.expv_kernel import (
    _res_xla,
    _window_jac_xla,
    make_window_jac,
)


def _mk_traj(N=9, free_time=True, seed=0, n_dr=2, xd=4):
    rng = np.random.default_rng(seed)
    data = {
        "x": 0.4 * rng.normal(size=(N, xd)),
        "u": 0.3 * rng.normal(size=(N, n_dr)),
    }
    if free_time:
        data["dt"] = 0.1 + 0.05 * rng.random((N, 1))
    return dtx.Trajectory.create(
        data,
        timestep="dt" if free_time else 0.12,
        controls="u",
        bounds={"dt": (0.01, 0.5)} if free_time else None,
    )


def _mk_integ(seed=0, n_dr=2, xd=4, order=6):
    rng = np.random.default_rng(100 + seed)
    Gd = rng.normal(size=(xd, xd))
    Gd = Gd - Gd.T
    Gv = [g - g.T for g in rng.normal(size=(n_dr, xd, xd))]
    return dtx.BilinearIntegrator.create(
        (Gd, Gv), "x", "u", None, method="taylor", taylor_order=order
    )


@pytest.mark.parametrize("free_time", [True, False])
@pytest.mark.parametrize("order", [3, 6, 12])
def test_closed_form_matches_jacfwd(free_time, order):
    """The tangent recurrences must equal jacfwd of the SAME Taylor chain
    to fp round-off (identical recurrence, identical division order)."""
    traj = _mk_traj(free_time=free_time)
    integ = _mk_integ(order=order)
    layout = traj.layout
    zmat = traj.to_zvec().reshape(layout.N, layout.dim)

    J_fast = stack_jacobians_zk(integ, layout, zmat)
    os.environ["DTX_ZK_KERNEL"] = "0"
    try:
        J_ref = stack_jacobians_zk(integ, layout, zmat)
    finally:
        os.environ.pop("DTX_ZK_KERNEL")
    np.testing.assert_allclose(
        np.asarray(J_fast), np.asarray(J_ref), atol=1e-13, rtol=1e-12
    )


def test_closed_form_matches_jacfwd_f32_batched():
    """vmapped over scenarios (the production shape), f32."""
    B = 5
    trajs = [_mk_traj(seed=s) for s in range(B)]
    integ = _mk_integ()
    layout = trajs[0].layout
    zb = jnp.stack(
        [t.to_zvec().reshape(layout.N, layout.dim) for t in trajs]
    ).astype(jnp.float32)
    integ32 = jax.tree.map(
        lambda x: x.astype(jnp.float32) if hasattr(x, "dtype") else x, integ
    )

    fast = jax.jit(jax.vmap(lambda z: stack_jacobians_zk(integ32, layout, z)))(zb)
    os.environ["DTX_ZK_KERNEL"] = "0"
    try:
        ref = jax.jit(jax.vmap(lambda z: stack_jacobians_zk(integ32, layout, z)))(zb)
    finally:
        os.environ.pop("DTX_ZK_KERNEL")
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), atol=2e-6)


def test_custom_vmap_unbatched_and_batched():
    rng = np.random.default_rng(5)
    K, xd, n_dr, order = 6, 4, 2, 6
    fn = make_window_jac(order, True)
    Gd = jnp.asarray(rng.normal(size=(xd, xd)))
    Gv = jnp.asarray(rng.normal(size=(n_dr, xd, xd)))
    u = jnp.asarray(0.3 * rng.normal(size=(K, n_dr)))
    dt = jnp.asarray(0.1 + 0.02 * rng.random(K))
    x = jnp.asarray(rng.normal(size=(K, xd)))
    out1 = fn(Gd, Gv, u, dt, x)
    assert out1.shape == (K, xd, xd + n_dr + 1)
    # batched (shared G broadcast: in_batched False on Gd/Gv)
    ub = jnp.stack([u, 2 * u, 0.5 * u])
    xb = jnp.stack([x, -x, x + 0.1])
    dtb = jnp.stack([dt, dt, dt * 1.1])
    outb = jax.vmap(lambda uu, tt, xx: fn(Gd, Gv, uu, tt, xx))(ub, dtb, xb)
    np.testing.assert_allclose(
        np.asarray(outb[0]), np.asarray(out1), atol=1e-12
    )


def test_residual_action_levels():
    """The two-level custom_vmap residual op: unbatched, trial-vmapped,
    problem-vmapped, and nested (problem × trial) all agree with the naive
    per-window evaluation."""
    from directtrajopt_tpu.ops.expv_kernel import (
        _res_xla,
        make_residual_action,
    )

    rng = np.random.default_rng(7)
    B, T, K, xd, n_dr, order = 3, 4, 6, 4, 2, 6
    fn = make_residual_action(order)
    Gd = jnp.asarray(rng.normal(size=(B, xd, xd)))
    Gv = jnp.asarray(rng.normal(size=(B, n_dr, xd, xd)))
    u = jnp.asarray(0.3 * rng.normal(size=(B, T, K, n_dr)))
    dt = jnp.asarray(0.1 + 0.02 * rng.random((B, T, K)))
    x = jnp.asarray(rng.normal(size=(B, T, K, xd)))
    xn = jnp.asarray(rng.normal(size=(B, T, K, xd)))

    ref = np.stack([
        np.stack([
            np.asarray(_res_xla(order, Gd[b], Gv[b], u[b, t], dt[b, t],
                                x[b, t], xn[b, t]))
            for t in range(T)
        ])
        for b in range(B)
    ])
    # unbatched
    out0 = fn(Gd[0], Gv[0], u[0, 0], dt[0, 0], x[0, 0], xn[0, 0])
    np.testing.assert_allclose(np.asarray(out0), ref[0, 0], atol=1e-12)
    # one level (trials of one problem — G unbatched)
    out1 = jax.vmap(lambda uu, tt, xx, nn: fn(Gd[0], Gv[0], uu, tt, xx, nn))(
        u[0], dt[0], x[0], xn[0]
    )
    np.testing.assert_allclose(np.asarray(out1), ref[0], atol=1e-12)
    # nested (problems × trials) under jit — the production shape
    out2 = jax.jit(
        jax.vmap(
            lambda gd, gv, uu, tt, xx, nn: jax.vmap(
                lambda u_, t_, x_, n_: fn(gd, gv, u_, t_, x_, n_)
            )(uu, tt, xx, nn)
        )
    )(Gd, Gv, u, dt, x, xn)
    np.testing.assert_allclose(np.asarray(out2), ref, atol=1e-12)


def test_residuals_stacked_matches_generic():
    """stack_residuals with the capability == the per-window residual()."""
    from directtrajopt_tpu.integrators.base import stack_residuals

    traj = _mk_traj(free_time=True)
    integ = _mk_integ(order=6)
    layout = traj.layout
    zmat = traj.to_zvec().reshape(layout.N, layout.dim)
    fast = stack_residuals(integ, layout, zmat)
    os.environ["DTX_RES_KERNEL"] = "0"
    try:
        ref = stack_residuals(integ, layout, zmat)
    finally:
        os.environ.pop("DTX_RES_KERNEL")
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), atol=1e-13)


def test_e2e_solve_matches_generic_path():
    """Full IPM solve with the closed-form prepare == generic-AD prepare."""
    from directtrajopt_tpu.benchmarks import make_bilinear_problem

    prob = make_bilinear_problem(N=21, feasible_start=True)
    res_fast = dtx.solve(prob, max_iter=60)
    # env toggles act at TRACE time — drop compiled programs in between
    jax.clear_caches()
    os.environ["DTX_ZK_KERNEL"] = "0"
    os.environ["DTX_RES_KERNEL"] = "0"
    try:
        res_ref = dtx.solve(prob, max_iter=60)
    finally:
        os.environ.pop("DTX_ZK_KERNEL")
        os.environ.pop("DTX_RES_KERNEL")
        jax.clear_caches()
    assert bool(res_fast.converged) and bool(res_ref.converged)
    np.testing.assert_allclose(
        np.asarray(res_fast.ipm.Z), np.asarray(res_ref.ipm.Z), atol=1e-7
    )


def _lane_args(rng, B, K, xd, n_dr):
    """Per-lane window data in the headline ranges (|u| ≤ 0.3, Δt ~ 0.1)."""
    Gd = rng.normal(size=(B, xd, xd))
    Gv = rng.normal(size=(B, n_dr, xd, xd))
    u = 0.3 * rng.normal(size=(B, K, n_dr))
    dt = 0.1 + 0.05 * rng.random((B, K))
    x = rng.normal(size=(B, K, xd))
    return Gd, Gv, u, dt, x


def _jacfwd_ref(order, free_time, Gd, Gv, u, dt, x):
    """f64 jacfwd of expv_taylor for every window of one lane."""

    def one(u_k, dt_k, x_k):
        def f(x_, u_, dt_):
            G = Gd + jnp.einsum("m,mij->ij", u_, Gv)
            return expv_taylor(dt_ * G, x_, order=order)

        Jx, Ju, Jt = jax.jacfwd(f, argnums=(0, 1, 2))(x_k, u_k, dt_k)
        parts = [Jx, Ju] + ([Jt[:, None]] if free_time else [])
        return jnp.concatenate(parts, axis=1)

    return jax.vmap(one)(u, dt, x)


@pytest.mark.parametrize("free_time", [True, False])
def test_vmapped_f32_matches_f64_jacfwd_odd_batch(free_time):
    """The batched closed form in f32 (the production dtype) against f64
    jacfwd of the Taylor chain, on an odd batch."""
    rng = np.random.default_rng(3)
    order = 6
    args = _lane_args(rng, 5, 7, 4, 2)
    out = jax.jit(jax.vmap(make_window_jac(order, free_time)))(
        *(jnp.asarray(a, jnp.float32) for a in args)
    )
    ref = jax.vmap(functools.partial(_jacfwd_ref, order, free_time))(
        *(jnp.asarray(a, jnp.float64) for a in args)
    )
    assert out.dtype == jnp.float32 and out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-6, rtol=1e-5)


def test_vmapped_residual_l1_f32_matches_f64():
    """Σ|residual| through the batched closed-form residuals, f32 vs f64."""
    from directtrajopt_tpu.integrators.base import stack_residuals_l1

    trajs = [_mk_traj(seed=s) for s in range(3)]
    integ = _mk_integ(order=6)
    layout = trajs[0].layout
    zb = jnp.stack([t.to_zvec().reshape(layout.N, layout.dim) for t in trajs])

    def l1(dtype):
        integ_d = jax.tree.map(
            lambda x: x.astype(dtype) if hasattr(x, "dtype") else x, integ
        )
        return jax.jit(jax.vmap(lambda z: stack_residuals_l1(integ_d, layout, z)))(
            zb.astype(dtype)
        )

    out32, out64 = l1(jnp.float32), l1(jnp.float64)
    assert out32.shape == (3,) and out32.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out32), np.asarray(out64), rtol=2e-6)


def test_residual_odd_batch_f32_matches_f64():
    rng = np.random.default_rng(9)
    order = 6
    Gd, Gv, u, dt, x = _lane_args(rng, 3, 5, 4, 2)
    xn = rng.normal(size=x.shape)
    args = (Gd, Gv, u, dt, x, xn)
    fn = jax.vmap(expv_kernel.make_residual_action(order))
    out = fn(*(jnp.asarray(a, jnp.float32) for a in args))
    ref = fn(*(jnp.asarray(a, jnp.float64) for a in args))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-6)


def test_padded_lanes_do_not_pollute():
    """Zero pad lanes (as the compacted chunks carry) leave the real lanes'
    Jacobians bit-identical and stay finite."""
    rng = np.random.default_rng(11)
    order = 6
    args = [jnp.asarray(a, jnp.float32) for a in _lane_args(rng, 3, 6, 4, 2)]
    padded = [jnp.concatenate([a, jnp.zeros((2,) + a.shape[1:], a.dtype)]) for a in args]
    fn = jax.jit(jax.vmap(make_window_jac(order, True)))
    out, out_p = fn(*args), fn(*padded)
    np.testing.assert_array_equal(np.asarray(out_p[:3]), np.asarray(out))
    assert np.isfinite(np.asarray(out_p)).all()


def test_batched_solve_routes_to_closed_form(monkeypatch):
    """Under vmap (the batched solve), the bilinear prepare stage calls the
    closed-form recurrence, not generic jacfwd."""
    calls = []

    def spy(*a):
        calls.append(a[0])
        return _window_jac_xla(*a)

    monkeypatch.setattr(expv_kernel, "_window_jac_xla", spy)
    expv_kernel.make_window_jac.cache_clear()
    try:
        trajs = [_mk_traj(seed=s) for s in range(2)]
        integ = _mk_integ(order=5)
        layout = trajs[0].layout
        zb = jnp.stack([t.to_zvec().reshape(layout.N, layout.dim) for t in trajs])
        fast = jax.vmap(lambda z: stack_jacobians_zk(integ, layout, z))(zb)
    finally:
        expv_kernel.make_window_jac.cache_clear()
    assert calls == [5]
    ref = np.stack([
        np.asarray(stack_jacobians_zk(integ, layout, z)) for z in zb
    ])
    np.testing.assert_allclose(np.asarray(fast), ref, atol=1e-13)
