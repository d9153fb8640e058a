"""Finite-difference derivative validators.

JAX analog of the reference's core quality gate: ``test_integrator``
(`/root/reference/src/integrators/_integrators.jl:97-242`), ``test_objective``
(`src/objectives/_objectives.jl:261-336`) and ``test_constraint``
(`src/constraints/_constraints.jl:150-238`) — every component's AD derivatives
are checked against central finite differences on the flat decision vector.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..integrators.base import stack_hessians, stack_jacobians, stack_residuals
from ..trajectory import Trajectory

__all__ = [
    "finite_difference_jacobian",
    "finite_difference_hessian",
    "assemble_window_jacobian",
    "assemble_window_hessian",
    "check_integrator",
]


def finite_difference_jacobian(f: Callable, x: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Central-difference Jacobian of ``f: (n,) -> (m,)``."""
    x = np.asarray(x, dtype=np.float64)
    f0 = np.asarray(f(x))
    J = np.zeros((f0.shape[0], x.shape[0]))
    for i in range(x.shape[0]):
        dx = np.zeros_like(x)
        dx[i] = eps
        J[:, i] = (np.asarray(f(x + dx)) - np.asarray(f(x - dx))) / (2 * eps)
    return J


def finite_difference_hessian(f: Callable, x: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Central-difference Hessian of a scalar function."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    H = np.zeros((n, n))
    for i in range(n):
        for j in range(i, n):
            ei = np.zeros(n)
            ej = np.zeros(n)
            ei[i] = eps
            ej[j] = eps
            fpp = float(f(x + ei + ej))
            fpm = float(f(x + ei - ej))
            fmp = float(f(x - ei + ej))
            fmm = float(f(x - ei - ej))
            H[i, j] = H[j, i] = (fpp - fpm - fmp + fmm) / (4 * eps**2)
    return H


def assemble_window_jacobian(blocks: jax.Array, N: int, dim: int, z_dim: int) -> np.ndarray:
    """Scatter per-window Jacobian blocks ``(N-1, r, 2dim)`` into a dense
    ``(r*(N-1), z_dim)`` matrix (rows per step, cols spanning knots k, k+1)."""
    blocks = np.asarray(blocks)
    r = blocks.shape[1]
    J = np.zeros((r * (N - 1), z_dim))
    for k in range(N - 1):
        J[k * r : (k + 1) * r, k * dim : (k + 2) * dim] = blocks[k]
    return J


def assemble_window_hessian(blocks: jax.Array, N: int, dim: int, z_dim: int) -> np.ndarray:
    """Accumulate per-window Hessian blocks ``(N-1, 2dim, 2dim)`` into a dense
    ``(z_dim, z_dim)`` matrix."""
    blocks = np.asarray(blocks)
    H = np.zeros((z_dim, z_dim))
    for k in range(N - 1):
        H[k * dim : (k + 2) * dim, k * dim : (k + 2) * dim] += blocks[k]
    return H


def check_objective(obj, traj: Trajectory, atol: float = 1e-5) -> None:
    """Validate an objective's AD gradient/Hessian against finite differences
    (the reference's ``test_objective``, `src/objectives/_objectives.jl:261-336`)."""
    from ..objectives.base import objective_value

    @jax.jit
    def val(zvec):
        return objective_value(obj, traj.from_zvec(zvec))

    z0 = np.asarray(traj.to_zvec(), dtype=np.float64)

    g_ad = np.asarray(jax.jit(jax.grad(val))(jnp.asarray(z0)))
    g_fd = finite_difference_jacobian(lambda z: np.asarray([val(jnp.asarray(z))]), z0)[0]
    np.testing.assert_allclose(g_ad, g_fd, atol=atol, rtol=0)

    H_ad = np.asarray(jax.jit(jax.hessian(val))(jnp.asarray(z0)))
    H_fd = finite_difference_hessian(lambda z: float(val(jnp.asarray(z))), z0)
    np.testing.assert_allclose(H_ad, H_fd, atol=max(atol * 100, 1e-4), rtol=0)


def check_constraint(con, traj: Trajectory, atol: float = 1e-5) -> None:
    """Validate a nonlinear constraint's AD Jacobian/Hessian against finite
    differences (the reference's ``test_constraint``,
    `src/constraints/_constraints.jl:150-238`)."""

    @jax.jit
    def flat(zvec):
        return con.evaluate_flat(traj.from_zvec(zvec))

    z0 = np.asarray(traj.to_zvec(), dtype=np.float64)
    J_ad = np.asarray(jax.jit(jax.jacfwd(flat))(jnp.asarray(z0)))
    J_fd = finite_difference_jacobian(lambda z: np.asarray(flat(jnp.asarray(z))), z0)
    np.testing.assert_allclose(J_ad, J_fd, atol=atol, rtol=0)

    rng = np.random.default_rng(7)
    mu = rng.normal(size=(J_ad.shape[0],))

    @jax.jit
    def lagr(zvec):
        return jnp.dot(jnp.asarray(mu), flat(zvec))

    H_ad = np.asarray(jax.jit(jax.hessian(lagr))(jnp.asarray(z0)))
    H_fd = finite_difference_hessian(lambda z: float(lagr(jnp.asarray(z))), z0)
    np.testing.assert_allclose(H_ad, H_fd, atol=max(atol * 100, 1e-4), rtol=0)


def check_integrator(
    integrator,
    traj: Trajectory,
    atol: float = 1e-5,
    hessian_atol: float | None = None,
) -> None:
    """Validate an integrator's AD Jacobian/Hessian against finite differences."""
    layout = traj.layout
    N, dim, z_dim = layout.N, layout.dim, layout.z_dim
    r = integrator.residual_dim(layout)

    @jax.jit
    def _flat_residual(zvec):
        tr = traj.from_zvec(zvec)
        return stack_residuals(integrator, layout, tr.knot_matrix()).reshape(-1)

    def flat_residual(zvec):
        return np.asarray(_flat_residual(jnp.asarray(zvec)))

    z0 = np.asarray(traj.to_zvec(), dtype=np.float64)

    # Jacobian check
    blocks = stack_jacobians(integrator, layout, traj.knot_matrix())
    J_ad = assemble_window_jacobian(blocks, N, dim, z_dim)
    J_fd = finite_difference_jacobian(flat_residual, z0)
    np.testing.assert_allclose(J_ad, J_fd, atol=atol, rtol=0)

    # Hessian-of-Lagrangian check
    rng = np.random.default_rng(42)
    mu = rng.normal(size=(N - 1, r))
    hblocks = stack_hessians(integrator, layout, traj.knot_matrix(), jnp.asarray(mu))
    H_ad = assemble_window_hessian(hblocks, N, dim, z_dim)

    def lagr(zvec):
        return float(mu.reshape(-1) @ flat_residual(zvec))

    H_fd = finite_difference_hessian(lagr, z0)
    np.testing.assert_allclose(
        H_ad, H_fd, atol=hessian_atol if hessian_atol is not None else 10 * atol, rtol=0
    )
