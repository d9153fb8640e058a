"""Closed-form bilinear window Jacobians and residuals.

The IPM's prepare stage needs, for every window, the Jacobian block

    J = ∂(E(u,Δt)·x)/∂(x, u, Δt),   E = Taylor_m(Δt·G(u)) action

Generic ``jacfwd`` through the expv Taylor chain materializes a dozen
intermediates per window. Here it is computed closed-form as the
hand-derived tangent recurrences of the Horner chain ``y ← x + (A·y)/k``
(identical values to ``jax.jacfwd`` of ``ops.expm.expv_taylor``, which is
what the generic path differentiates):

    Ė-col chains (∂/∂x = E),   ẏ_m = (Ȧ_m y + A ẏ_m)/k  (∂/∂u_m),
    ẏ_t = (G y + A ẏ_t)/k  (∂/∂Δt)

plus the primal chain alone for the line search's residuals. Both are plain
``jnp`` recurrences: under ``vmap`` (the batched solve) XLA fuses each
Horner step into a few loop fusions, and nothing is sequential across knots.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp

__all__ = ["make_window_jac", "make_residual_action"]


def _window_jac_xla(order, free_time, Gd, Gv, u, dt, x):
    """(K, xd, n_th) = ∂(E x)/∂(x, u[, Δt]) for all K = N−1 windows.

    Gd (xd,xd), Gv (n_dr,xd,xd), u (K,n_dr), dt (K,), x (K,xd).
    """
    K, xd = x.shape
    n_dr = Gv.shape[0]
    dtype = x.dtype
    G = Gd[None] + jnp.einsum("km,mij->kij", u, Gv)
    A = dt[:, None, None] * G
    eye = jnp.broadcast_to(jnp.eye(xd, dtype=dtype), (K, xd, xd))
    E = eye
    y = x
    yd_u = jnp.zeros((K, n_dr, xd), dtype)
    yd_t = jnp.zeros((K, xd), dtype)
    Ad_u = dt[:, None, None, None] * jnp.broadcast_to(
        Gv[None], (K, n_dr, xd, xd)
    )
    for k in range(order, 0, -1):
        # tangents first: they reference the PREVIOUS y (jacfwd order)
        yd_u = (
            jnp.einsum("kmij,kj->kmi", Ad_u, y)
            + jnp.einsum("kij,kmj->kmi", A, yd_u)
        ) / k
        if free_time:
            yd_t = (
                jnp.einsum("kij,kj->ki", G, y) + jnp.einsum("kij,kj->ki", A, yd_t)
            ) / k
        E = eye + jnp.einsum("kij,kjl->kil", A, E) / k
        y = x + jnp.einsum("kij,kj->ki", A, y) / k
    parts = [E, jnp.transpose(yd_u, (0, 2, 1))]
    if free_time:
        parts.append(yd_t[:, :, None])
    return jnp.concatenate(parts, axis=2)


def _res_xla(order, Gd, Gv, u, dt, x, xn):
    """(K, xd) bilinear dynamics residuals, one instance (trial or lane)."""
    G = Gd[None] + jnp.einsum("km,mij->kij", u, Gv)
    A = dt[:, None, None] * G
    y = x
    for k in range(order, 0, -1):
        y = x + jnp.einsum("kij,kj->ki", A, y) / k
    return xn - y


@functools.lru_cache(maxsize=None)
def make_residual_action(order: int):
    """Residual op ``fn(Gd, Gv, u, dt, x, xn) -> (K, xd)`` for one order."""
    return functools.partial(_res_xla, order)


@functools.lru_cache(maxsize=None)
def make_window_jac(order: int, free_time: bool):
    """Window-Jacobian op for one (order, free_time).

    Signature: ``fn(Gd, Gv, u, dt, x) -> (K, xd, n_th)`` with
    ``n_th = xd + n_dr (+1 if free_time)`` — columns ordered (x, u, Δt).
    """
    return functools.partial(_window_jac_xla, order, free_time)
