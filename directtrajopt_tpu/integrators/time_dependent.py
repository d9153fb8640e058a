"""Time-dependent bilinear integrator and general explicit-ODE integrator.

``TimeDependentBilinearIntegrator`` mirrors
`/root/reference/src/integrators/time_dependent_bilinear_integrator.jl:60-132`:
residual ``x_{k+1} − ODESolve(ẋ = Δt·G(u(τ), t_k + τΔt)·x, τ∈[0,1])`` with the
control interpolated at spline order 0 (ZOH: u_k) or 1 (linear between u_k and
u_{k+1} — note order 1 couples the residual to BOTH knots,
`time_dependent_bilinear_integrator.jl:161-163`). The reference differentiates
through an adaptive Tsit5 solve; adaptive stepping doesn't jit, so here the
solve is a fixed-step RK4 (`n_steps` static) — a fixed chain the compiler
fuses and AD traverses exactly (the reference's own tests only require
atol=1e-3 agreement, `:248-269`).

``GeneralIntegrator`` covers arbitrary explicit dynamics ``ẋ = f(x, u)``
(cartpole-class problems) with Euler or RK4 stepping — a capability the
reference composes out of DerivativeIntegrators + nonlinear constraints.
"""

from __future__ import annotations

from typing import Callable

import jax

from ..module import module, static_field
from ..trajectory import Layout, Trajectory

__all__ = [
    "TimeDependentBilinearIntegrator",
    "GeneralIntegrator",
    "rk4_step",
    "td_integration_error",
    "tune_n_steps",
]


def rk4_step(f: Callable, x: jax.Array, h, *args) -> jax.Array:
    k1 = f(x, *args)
    k2 = f(x + 0.5 * h * k1, *args)
    k3 = f(x + 0.5 * h * k2, *args)
    k4 = f(x + h * k3, *args)
    return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


@module
class TimeDependentBilinearIntegrator:
    """``x_{k+1} = ODESolve(ẋ = G(u(τ), t)·x)`` with spline-interpolated u."""

    G_fn: Callable = static_field()
    x_name: str = static_field()
    u_name: str = static_field()
    t_name: str = static_field(default="t")
    spline_order: int = static_field(default=1)
    n_steps: int = static_field(default=10)
    # Substitution closure ``u_{k+1} = u_next_fn(layout, z_k, k)`` installed
    # by the Riccati lowering pass (`solvers.solve._lower_order1_td`) when
    # another explicit integrator already determines u_{k+1} from z_k (e.g. a
    # u→du derivative chain): the order-1 residual then reads only z_k (plus
    # the identity target coupling), restoring the x_{k+1} − F(z_k) form the
    # Riccati core requires. Exact — both constraint systems have the same
    # solution set. Set only inside a trace (closures are not stable jit-cache
    # keys), never on user-constructed integrators.
    u_next_fn: Callable | None = static_field(default=None)

    @staticmethod
    def create(
        G: Callable,
        x_name: str,
        u_name: str,
        t_name: str,
        traj: Trajectory | None = None,
        *,
        spline_order: int = 1,
        n_steps: int = 10,
    ) -> "TimeDependentBilinearIntegrator":
        if spline_order not in (0, 1):
            raise ValueError(f"unsupported spline order {spline_order}")
        return TimeDependentBilinearIntegrator(
            G_fn=G,
            x_name=x_name,
            u_name=u_name,
            t_name=t_name,
            spline_order=spline_order,
            n_steps=n_steps,
        )

    @property
    def explicit(self) -> bool:
        # order 1 couples u_{k+1}, breaking the x_{k+1} − F(z_k) form the
        # Riccati core requires; order 0 (ZOH) is explicit, as is order 1
        # after the u_{k+1} substitution (see u_next_fn)
        return self.spline_order == 0 or self.u_next_fn is not None

    def residual_dim(self, layout: Layout) -> int:
        return layout.dim_of(self.x_name)

    def read_cols(self, layout: Layout):
        """z_k columns the residual reads (x, u, t, Δt) — restricts window AD."""
        if self.u_next_fn is not None:
            # the substitution may read any z_k column the chain reads —
            # fall back to full width (disables the restriction)
            return list(range(layout.dim))
        cs_x, cs_u = layout.comp_slice(self.x_name), layout.comp_slice(self.u_name)
        cs_t = layout.comp_slice(self.t_name)
        cols = (
            list(range(cs_x.start, cs_x.stop))
            + list(range(cs_u.start, cs_u.stop))
            + list(range(cs_t.start, cs_t.stop))
        )
        if layout.has_free_time:
            cols.append(layout.offsets[layout.timestep])
        return cols

    def read_cols_next(self, layout: Layout):
        """z_{k+1} columns: x always; u too at spline order 1 (unless the
        u_{k+1} substitution removed that coupling)."""
        cs_x = layout.comp_slice(self.x_name)
        cols = list(range(cs_x.start, cs_x.stop))
        if self.spline_order == 1 and self.u_next_fn is None:
            cs_u = layout.comp_slice(self.u_name)
            cols += list(range(cs_u.start, cs_u.stop))
        return cols

    def residual(self, layout: Layout, w: jax.Array, k: jax.Array) -> jax.Array:
        dim = layout.dim
        zk, zk1 = w[:dim], w[dim:]
        x = layout.knot_extract(zk, self.x_name)
        x_next = layout.knot_extract(zk1, self.x_name)
        u_k = layout.knot_extract(zk, self.u_name)
        t_k = layout.knot_extract(zk, self.t_name)[0]
        dt = layout.knot_timestep(zk, dtype=w.dtype)

        if self.spline_order == 0:
            u_of = lambda tau: u_k
        else:
            if self.u_next_fn is not None:
                u_k1 = self.u_next_fn(layout, zk, k)
            else:
                u_k1 = layout.knot_extract(zk1, self.u_name)
            u_of = lambda tau: u_k + tau * (u_k1 - u_k)

        h = 1.0 / self.n_steps

        def ode(x_, tau):
            return dt * (self.G_fn(u_of(tau), t_k + tau * dt) @ x_)

        y = x
        for i in range(self.n_steps):
            tau0 = i * h
            # RK4 with τ-dependent right-hand side
            k1 = ode(y, tau0)
            k2 = ode(y + 0.5 * h * k1, tau0 + 0.5 * h)
            k3 = ode(y + 0.5 * h * k2, tau0 + 0.5 * h)
            k4 = ode(y + h * k3, tau0 + h)
            y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return x_next - y

    def __repr__(self):
        return (
            f"TimeDependentBilinearIntegrator: {self.x_name} = "
            f"ODESolve(G({self.u_name}(τ), {self.t_name})) (order "
            f"{self.spline_order})"
        )


def td_integration_error(integ, layout: Layout, zmat: jax.Array) -> jax.Array:
    """Per-window RK4 truncation-error estimate by step doubling.

    The reference integrates the TD residual with adaptive Tsit5 under user
    tolerances (`time_dependent_bilinear_integrator.jl:70-132`); adaptive
    stepping is data-dependent control flow a jitted lockstep batch cannot
    afford, so the scheme here is a STATIC ``n_steps`` fixed-step RK4
    validated (and, via :func:`tune_n_steps`, chosen) at setup time. This
    returns the classic step-doubling estimate for that validation: with
    RK4's O(h⁴) local order, ``err ≈ ‖y_n − y_2n‖∞ / 15`` per window
    (Richardson; Hairer–Nørsett–Wanner II.4). Jittable, static shapes.

    Shapes: zmat (N, dim) → (N−1,) max-norm error per window.
    """
    import jax.numpy as jnp

    from .base import windows

    W = windows(zmat)
    ks = jnp.arange(layout.N - 1)
    integ2 = integ.replace(n_steps=2 * integ.n_steps)

    def err(w, k):
        r1 = integ.residual(layout, w, k)
        r2 = integ2.residual(layout, w, k)
        # residual = x_next − y, so r1 − r2 = y_2n − y_n
        return jnp.max(jnp.abs(r1 - r2)) / 15.0

    return jax.vmap(err)(W, ks)


def tune_n_steps(
    integ,
    traj: Trajectory,
    *,
    atol: float = 1e-3,
    start: int | None = None,
    max_n_steps: int = 640,
) -> tuple["TimeDependentBilinearIntegrator", float]:
    """Pick the smallest power-of-two multiple of ``n_steps`` meeting ``atol``.

    Host-side doubling loop over the jittable step-doubling estimate —
    the static-shape analog of the reference's adaptive-tolerance ODE solve
    (`time_dependent_bilinear_integrator.jl:70-132`, default reltol 1e-6 /
    abstol 1e-6; its own integrator tests accept atol=1e-3 agreement,
    `:248-269`): adaptivity runs ONCE at problem-setup time on the initial
    trajectory, then the solve compiles a fixed chain. The estimate is
    evaluated at the initial guess; since the optimizer moves u within its
    bounds, pass a representative (e.g. bound-saturated) trajectory for a
    conservative choice.

    Returns ``(integrator_with_tuned_n_steps, max_window_error_estimate)``.
    """
    import numpy as np

    layout = traj.layout
    zmat = traj.to_zvec()[: layout.N * layout.dim].reshape(layout.N, layout.dim)
    n = start if start is not None else integ.n_steps
    while True:
        cand = integ.replace(n_steps=n)
        e = float(np.max(np.asarray(td_integration_error(cand, layout, zmat))))
        if e <= atol or n >= max_n_steps:
            return cand, e
        n *= 2


@module
class GeneralIntegrator:
    """Explicit discretization of ``ẋ = f(x, u)``: Euler or RK4 step."""

    f: Callable = static_field()
    x_name: str = static_field()
    u_name: str = static_field()
    scheme: str = static_field(default="rk4")  # "euler" | "rk4"

    explicit = True

    @staticmethod
    def create(
        f: Callable, x_name: str, u_name: str, traj=None, *, scheme: str = "rk4"
    ) -> "GeneralIntegrator":
        if scheme not in ("euler", "rk4"):
            raise ValueError(f"unknown scheme {scheme}")
        return GeneralIntegrator(f=f, x_name=x_name, u_name=u_name, scheme=scheme)

    def residual_dim(self, layout: Layout) -> int:
        return layout.dim_of(self.x_name)

    def read_cols(self, layout: Layout):
        """z_k columns the residual reads (x, u, Δt) — restricts window AD."""
        cs_x, cs_u = layout.comp_slice(self.x_name), layout.comp_slice(self.u_name)
        cols = list(range(cs_x.start, cs_x.stop)) + list(range(cs_u.start, cs_u.stop))
        if layout.has_free_time:
            cols.append(layout.offsets[layout.timestep])
        return cols

    def residual(self, layout: Layout, w: jax.Array, k: jax.Array) -> jax.Array:
        dim = layout.dim
        zk, zk1 = w[:dim], w[dim:]
        x = layout.knot_extract(zk, self.x_name)
        x_next = layout.knot_extract(zk1, self.x_name)
        u = layout.knot_extract(zk, self.u_name)
        dt = layout.knot_timestep(zk, dtype=w.dtype)
        if self.scheme == "euler":
            y = x + dt * self.f(x, u)
        else:
            y = rk4_step(lambda x_, u_: self.f(x_, u_), x, dt, u)
        return x_next - y

    def __repr__(self):
        return f"GeneralIntegrator({self.scheme}): {self.x_name}' = f({self.x_name}, {self.u_name})"
