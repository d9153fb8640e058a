"""Structured derivative assembly for the canonical NLP.

The reference evaluates derivatives per component with ForwardDiff and
scatters them through precomputed sparse index maps
(`/root/reference/src/solvers/evaluator.jl:368-404,491-647`). Here the same
block structure is exploited the batched way: per-window / per-knot derivative
blocks come from *vmapped* ``jacfwd`` / ``hessian`` (one batched kernel per
component instead of N Julia loop iterations), and are scattered into dense
matrices with precomputed static index grids. The block layout is

* equality rows: ``[dynamics (per integrator, k-major) ; A_eq ; nonlinear eq]``
* inequality rows: ``[A_in ; nonlinear ineq]``
* Lagrangian Hessian: σ·(per-knot objective blocks + global arrowhead)
  + window blocks from dynamics + knot blocks from nonlinear constraints.

The same blocks feed the block-tridiagonal Riccati KKT path without the dense
scatter; the dense form here is the reference/validation path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..integrators.base import stack_hessians, stack_jacobians
from .canonical import CanonicalNLP

__all__ = ["gradient", "jac_eq", "jac_in", "hess_lagrangian", "split_Z"]


def split_Z(nlp: CanonicalNLP, Z: jax.Array):
    layout = nlp.layout
    zmat = Z[..., : layout.N * layout.dim].reshape(
        *Z.shape[:-1], layout.N, layout.dim
    )
    gvec = Z[..., layout.N * layout.dim :]
    return zmat, gvec


def gradient(nlp: CanonicalNLP, Z: jax.Array) -> jax.Array:
    """Objective gradient ∇f(Z)."""
    return jax.grad(nlp.objective)(Z)


def jac_eq(nlp: CanonicalNLP, Z: jax.Array) -> jax.Array:
    """Dense equality-constraint Jacobian (n_eq, z_dim)."""
    layout = nlp.layout
    N, dim, z_dim = layout.N, layout.dim, nlp.z_dim
    zmat, gvec = split_Z(nlp, Z)
    J = jnp.zeros((nlp.n_eq, z_dim), dtype=Z.dtype)

    off = 0
    for integ in nlp.integrators:
        r = integ.residual_dim(layout)
        blocks = stack_jacobians(integ, layout, zmat)  # (N-1, r, 2dim)
        ks = np.arange(N - 1)
        rows = off + (ks * r)[:, None, None] + np.arange(r)[None, :, None]
        cols = (ks * dim)[:, None, None] + np.arange(2 * dim)[None, None, :]
        J = J.at[jnp.asarray(rows), jnp.asarray(cols)].add(blocks)
        off += r * (N - 1)

    if nlp.n_lin_eq:
        J = J.at[off : off + nlp.n_lin_eq].set(nlp.A_eq.dense(J.dtype))
        off += nlp.n_lin_eq

    J = _add_nl_jacobian(nlp, J, zmat, gvec, nlp.eq_cons, off)
    return J


def jac_in(nlp: CanonicalNLP, Z: jax.Array) -> jax.Array:
    """Dense inequality-constraint Jacobian (n_in, z_dim)."""
    zmat, gvec = split_Z(nlp, Z)
    J = jnp.zeros((nlp.n_in, nlp.z_dim), dtype=Z.dtype)
    off = 0
    if nlp.n_lin_in:
        J = J.at[:nlp.n_lin_in].set(nlp.A_in.dense(J.dtype))
        off += nlp.n_lin_in
    J = _add_nl_jacobian(nlp, J, zmat, gvec, nlp.in_cons, off)
    return J


def _add_nl_jacobian(nlp, J, zmat, gvec, cons, off):
    layout = nlp.layout
    dim = layout.dim
    g_base = layout.N * dim
    g_dim_tot = layout.global_dim
    for con in cons:
        if hasattr(con, "knot_residual"):
            times = np.asarray(con.times)
            T, gd = len(times), con.g_dim
            z_sel = zmat[jnp.asarray(times)]
            idx = jnp.arange(T)
            jac_z = jax.vmap(
                jax.jacfwd(lambda z, g, i: con.knot_residual(layout, z, g, i), argnums=0),
                in_axes=(0, None, 0),
            )(z_sel, gvec, idx)  # (T, gd, dim)
            rows = off + (np.arange(T) * gd)[:, None, None] + np.arange(gd)[None, :, None]
            cols = (times * dim)[:, None, None] + np.arange(dim)[None, None, :]
            J = J.at[jnp.asarray(rows), jnp.asarray(cols)].add(jac_z)
            if g_dim_tot and getattr(con, "uses_global", False):
                jac_g = jax.vmap(
                    jax.jacfwd(
                        lambda z, g, i: con.knot_residual(layout, z, g, i), argnums=1
                    ),
                    in_axes=(0, None, 0),
                )(z_sel, gvec, idx)  # (T, gd, g_dim_tot)
                gcols = g_base + np.arange(g_dim_tot)
                cols_g = np.broadcast_to(gcols[None, None, :], (T, gd, g_dim_tot))
                J = J.at[jnp.asarray(rows), jnp.asarray(cols_g)].add(jac_g)
            off += T * gd
        else:  # NonlinearGlobalConstraint
            gd = con.g_dim
            jac_g = jax.jacfwd(lambda g: con.global_residual(layout, g))(gvec)
            J = J.at[off : off + gd, g_base:].add(jac_g)
            off += gd
    return J


def hess_lagrangian(
    nlp: CanonicalNLP,
    Z: jax.Array,
    lam: jax.Array,
    nu: jax.Array,
    sigma: jax.Array | float = 1.0,
    gauss_newton: bool = False,
) -> jax.Array:
    """Dense Hessian of the Lagrangian σ∇²f + Σλᵢ∇²c_eq,i + Σνⱼ∇²c_in,j.

    Assembled block-wise: per-knot objective blocks, per-window dynamics
    blocks, per-knot nonlinear-constraint blocks, global arrowhead.
    ``gauss_newton`` drops the λ/ν-weighted constraint-curvature blocks
    (objective curvature only — see ``IPMOptions.hessian_approximation``).
    """
    layout = nlp.layout
    N, dim, z_dim = layout.N, layout.dim, nlp.z_dim
    gdim = layout.global_dim
    g_base = N * dim
    zmat, gvec = split_Z(nlp, Z)
    H = jnp.zeros((z_dim, z_dim), dtype=Z.dtype)

    obj = nlp.objective_obj
    knot_cols = (np.arange(N) * dim)[:, None] + np.arange(dim)[None, :]  # (N, dim)

    # -- objective: per-knot blocks (+ global coupling if used) ----------- #
    if gdim and obj.uses_global:
        def knot_cost_w(w, k):
            return obj.cost_at_knot(layout, w[:dim], w[dim:], k)

        blocks = jax.vmap(jax.hessian(knot_cost_w), in_axes=(0, 0))(
            jnp.concatenate([zmat, jnp.broadcast_to(gvec, (N, gdim))], axis=-1),
            jnp.arange(N),
        )  # (N, dim+gdim, dim+gdim)
        Hzz = blocks[:, :dim, :dim]
        Hzg = blocks[:, :dim, dim:]
        Hgg = jnp.sum(blocks[:, dim:, dim:], axis=0)
        rows = knot_cols[:, :, None]
        cols = knot_cols[:, None, :]
        H = H.at[jnp.asarray(rows), jnp.asarray(cols)].add(sigma * Hzz)
        gcols = np.broadcast_to(
            (g_base + np.arange(gdim))[None, None, :], (N, dim, gdim)
        )
        H = H.at[jnp.asarray(knot_cols[:, :, None]), jnp.asarray(gcols)].add(
            sigma * Hzg
        )
        # symmetric counterpart of the cross block
        H = H.at[g_base:, :g_base].add(
            jnp.moveaxis(sigma * Hzg, -1, 0).reshape(gdim, N * dim)
        )
        H = H.at[g_base:, g_base:].add(sigma * Hgg)
    else:
        blocks = jax.vmap(
            jax.hessian(lambda z, k: obj.cost_at_knot(layout, z, gvec, k)),
            in_axes=(0, 0),
        )(zmat, jnp.arange(N))  # (N, dim, dim)
        H = H.at[jnp.asarray(knot_cols[:, :, None]), jnp.asarray(knot_cols[:, None, :])].add(
            sigma * blocks
        )

    if gdim:
        Hg = jax.hessian(lambda g: obj.cost_global(layout, g))(gvec)
        H = H.at[g_base:, g_base:].add(sigma * Hg)

    if gauss_newton:
        return H

    # -- dynamics window blocks ------------------------------------------- #
    off = 0
    win_cols = (np.arange(N - 1) * dim)[:, None] + np.arange(2 * dim)[None, :]
    for integ in nlp.integrators:
        r = integ.residual_dim(layout)
        mu = lam[off : off + r * (N - 1)].reshape(N - 1, r)
        blocks = stack_hessians(integ, layout, zmat, mu)  # (N-1, 2dim, 2dim)
        H = H.at[jnp.asarray(win_cols[:, :, None]), jnp.asarray(win_cols[:, None, :])].add(
            blocks
        )
        off += r * (N - 1)

    off += nlp.n_lin_eq  # affine rows: no curvature
    H = _add_nl_hessian(nlp, H, zmat, gvec, nlp.eq_cons, lam, off)
    H = _add_nl_hessian(nlp, H, zmat, gvec, nlp.in_cons, nu, nlp.n_lin_in)
    return H


def _add_nl_hessian(nlp, H, zmat, gvec, cons, mults, off):
    layout = nlp.layout
    dim, gdim = layout.dim, layout.global_dim
    g_base = layout.N * dim
    for con in cons:
        if hasattr(con, "knot_residual"):
            times = np.asarray(con.times)
            T, gd = len(times), con.g_dim
            mu = mults[off : off + T * gd].reshape(T, gd)
            z_sel = zmat[jnp.asarray(times)]
            idx = jnp.arange(T)
            if gdim and getattr(con, "uses_global", False):
                def lagr(w, i, m):
                    return jnp.dot(m, con.knot_residual(layout, w[:dim], w[dim:], i))

                blocks = jax.vmap(
                    lambda w, i, m: jax.hessian(lagr)(w, i, m)
                )(
                    jnp.concatenate(
                        [z_sel, jnp.broadcast_to(gvec, (T, gdim))], axis=-1
                    ),
                    idx,
                    mu,
                )  # (T, dim+gdim, dim+gdim)
                kc = times[:, None] * dim + np.arange(dim)[None, :]
                H = H.at[jnp.asarray(kc[:, :, None]), jnp.asarray(kc[:, None, :])].add(
                    blocks[:, :dim, :dim]
                )
                gcols = np.broadcast_to(
                    (g_base + np.arange(gdim))[None, None, :], (T, dim, gdim)
                )
                H = H.at[jnp.asarray(kc[:, :, None]), jnp.asarray(gcols)].add(
                    blocks[:, :dim, dim:]
                )
                H = H.at[jnp.asarray(gcols.transpose(0, 2, 1)), jnp.asarray(kc[:, None, :])].add(
                    blocks[:, dim:, :dim]
                )
                H = H.at[g_base:, g_base:].add(jnp.sum(blocks[:, dim:, dim:], axis=0))
            else:
                def lagr_z(z, i, m):
                    return jnp.dot(m, con.knot_residual(layout, z, gvec, i))

                blocks = jax.vmap(
                    lambda z, i, m: jax.hessian(lagr_z)(z, i, m)
                )(z_sel, idx, mu)  # (T, dim, dim)
                kc = times[:, None] * dim + np.arange(dim)[None, :]
                H = H.at[jnp.asarray(kc[:, :, None]), jnp.asarray(kc[:, None, :])].add(
                    blocks
                )
            off += T * gd
        else:  # NonlinearGlobalConstraint
            gd = con.g_dim
            mu = mults[off : off + gd]
            Hg = jax.hessian(
                lambda g: jnp.dot(mu, con.global_residual(layout, g))
            )(gvec)
            H = H.at[g_base:, g_base:].add(Hg)
            off += gd
    return H
