"""Integrator interface: dynamics as batched two-knot window residuals.

The reference represents dynamics as per-step residuals
``δ_k = f(x_{k+1}, x_k, u_k, Δt_k)`` with hand-assembled sparse Jacobian and
Hessian structure (`/root/reference/src/integrators/_integrators.jl:34-77`).
Here an integrator is a pytree exposing one pure function

    residual(layout, w, k) -> (x_dim,)

on the stacked window ``w = [z_k; z_{k+1}]`` (shape ``(2*dim,)``), evaluated
for all k at once by ``vmap`` and differentiated by ``jacfwd`` / ``hessian``
over the window — the per-window derivative *is* the sparse block, so the
reference's sparsity-structure machinery disappears: the KKT system is
assembled block-wise from these ``(x_dim, 2dim)`` / ``(2dim, 2dim)`` blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..trajectory import Layout, Trajectory

__all__ = [
    "windows",
    "stack_residuals",
    "stack_jacobians",
    "stack_hessians",
    "integrator_dim",
]


def windows(zmat: jax.Array) -> jax.Array:
    """Stack adjacent knots: ``(N, dim) -> (N-1, 2*dim)`` with rows [z_k; z_{k+1}]."""
    return jnp.concatenate([zmat[..., :-1, :], zmat[..., 1:, :]], axis=-1)


def integrator_dim(integrator, layout: Layout) -> int:
    """Total residual dimension ``x_dim * (N-1)``."""
    return integrator.residual_dim(layout) * (layout.N - 1)


def stack_residuals(integrator, layout: Layout, zmat: jax.Array) -> jax.Array:
    """Evaluate all window residuals: ``(N-1, x_dim)``."""
    import os

    # integrator-provided closed-form stack (bilinear expv action — the
    # line-search trial grid is the hottest caller)
    custom = getattr(integrator, "residuals_stacked", None)
    if custom is not None and os.environ.get("DTX_RES_KERNEL", "1") != "0":
        out = custom(layout, zmat)
        if out is not None:
            return out

    W = windows(zmat)
    ks = jnp.arange(layout.N - 1)
    return jax.vmap(lambda w, k: integrator.residual(layout, w, k))(W, ks)


def stack_residuals_l1(integrator, layout: Layout, zmat: jax.Array):
    """``Σ|residual|`` over all windows — scalar."""
    return jnp.sum(jnp.abs(stack_residuals(integrator, layout, zmat)))


def stack_jacobians(integrator, layout: Layout, zmat: jax.Array) -> jax.Array:
    """Per-window residual Jacobians: ``(N-1, x_dim, 2*dim)``."""
    W = windows(zmat)
    ks = jnp.arange(layout.N - 1)
    cols = _window_cols(integrator, layout)
    if cols is None:
        jac = jax.jacfwd(lambda w, k: integrator.residual(layout, w, k))
        return jax.vmap(jac)(W, ks)
    E, keep = _embedding(cols, 2 * layout.dim, zmat.dtype)

    def res_r(wr, w, k):
        return integrator.residual(layout, w * keep + wr @ E, k)

    Jr = jax.vmap(jax.jacfwd(res_r, argnums=0))(W @ E.T, W, ks)
    return Jr @ E


def stack_hessians(
    integrator, layout: Layout, zmat: jax.Array, mu: jax.Array
) -> jax.Array:
    """Per-window Hessians of ``μ_k ⋅ residual_k``: ``(N-1, 2*dim, 2*dim)``.

    ``mu`` has shape ``(N-1, x_dim)`` (dynamics multipliers per step).
    """
    d = layout.dim
    W = windows(zmat)
    ks = jnp.arange(layout.N - 1)

    # explicit integrators are linear in z_{k+1}: the whole window Hessian is
    # the z_k block, which a structure-exploiting hessian_zk provides directly
    import os

    custom = getattr(integrator, "hessian_zk", None)
    if custom is not None and not os.environ.get("DTX_NO_CUSTOM_HESS"):
        Hk = jax.vmap(lambda zk, zk1, k, m: custom(layout, zk, zk1, k, m))(
            zmat[..., :-1, :], zmat[..., 1:, :], ks, mu
        )
        return jnp.pad(Hk, ((0, 0), (0, d), (0, d)))

    def lagr(w, k, m):
        return jnp.dot(m, integrator.residual(layout, w, k))

    cols = _window_cols(integrator, layout)
    if cols is None:
        hess = jax.hessian(lagr)
        return jax.vmap(lambda w, k, m: hess(w, k, m))(W, ks, mu)
    E, keep = _embedding(cols, 2 * d, zmat.dtype)

    def lagr_r(wr, w, k, m):
        return lagr(w * keep + wr @ E, k, m)

    Hr = jax.vmap(jax.hessian(lagr_r, argnums=0))(W @ E.T, W, ks, mu)
    return jnp.einsum("kab,ad,be->kde", Hr, E, E)


def _read_cols(integrator, layout: Layout) -> np.ndarray | None:
    """Static z_k-column indices the integrator's residual reads, or None
    for "all of them". Differentiating only these columns (through one-hot
    embedding matmuls) shrinks the AD tangent count quadratically for the
    Hessian. Measured caveat: for the *small* z_k blocks of the Riccati path
    (d≈11) the generic full-width AD is FASTER — XLA batches the dual-number
    tangents into one widened pass, while the embedding form adds unfused
    ops (CPU B=8: 22.0 → 26.7 ms/IPM-iteration).
    The restriction pays off on the 2·dim dense *window* path, where the
    tangent count doubles. Hence the two gates below."""
    import os

    if os.environ.get("DTX_NO_READCOLS"):  # perf-ablation escape hatch
        return None
    fn = getattr(integrator, "read_cols", None)
    if fn is None:
        return None
    cols = np.unique(np.asarray(fn(layout), dtype=np.int64))
    if len(cols) >= layout.dim:
        return None
    return cols


def _window_cols(integrator, layout: Layout) -> np.ndarray | None:
    """Static column indices the residual reads within the 2·dim window, or
    None for all. The z_k half comes from ``read_cols``; the z_{k+1} half
    defaults to the target-x columns (explicit form) unless the integrator
    declares ``read_cols_next`` (e.g. order-1 control splines also read
    u_{k+1})."""
    cols_k = _read_cols(integrator, layout)
    if cols_k is None:
        return None
    d = layout.dim
    fn = getattr(integrator, "read_cols_next", None)
    if fn is not None:
        nxt = np.unique(np.asarray(fn(layout), dtype=np.int64))
    else:
        x_name = getattr(integrator, "x_name", None)
        if x_name is None:
            return None
        cs = layout.comp_slice(x_name)
        nxt = np.arange(cs.start, cs.stop, dtype=np.int64)
    return np.concatenate([cols_k, d + nxt])


def _embedding(cols: np.ndarray, dim: int, dtype):
    """Static one-hot embedding ``E (n_read, dim)`` and keep-mask ``(dim,)``.

    Scatters/gathers with index arrays lower to scatter ops; expressing the
    same restriction as tiny one-hot matmuls keeps everything fusible.
    """
    E = np.zeros((len(cols), dim))
    E[np.arange(len(cols)), cols] = 1.0
    keep = np.ones((dim,))
    keep[cols] = 0.0
    return jnp.asarray(E, dtype=dtype), jnp.asarray(keep, dtype=dtype)


def stack_jacobians_zk(integrator, layout: Layout, zmat: jax.Array) -> jax.Array:
    """Per-window residual Jacobians w.r.t. ``z_k`` only: ``(N-1, r, dim)``.

    For explicit integrators (residual ``x_{k+1} − F(z_k)``) this is the whole
    nontrivial Jacobian — the ``z_{k+1}`` part is the identity selection of
    the target components. Used by the Riccati KKT backend.
    """
    import os

    # integrator-provided closed-form stack (e.g. the bilinear expv tangent
    # recurrences) in place of the generic jacfwd path below
    custom = getattr(integrator, "jacobians_zk_stacked", None)
    if custom is not None and os.environ.get("DTX_ZK_KERNEL", "1") != "0":
        out = custom(layout, zmat)
        if out is not None:
            return out

    dim = layout.dim
    ks = jnp.arange(layout.N - 1)
    # generic full-width AD by default: fastest at z_k width (see _read_cols)
    cols = _read_cols(integrator, layout) if os.environ.get("DTX_ZK_READCOLS") else None

    if cols is None:

        def res_zk(zk, zk1, k):
            return integrator.residual(layout, jnp.concatenate([zk, zk1]), k)

        jac = jax.jacfwd(res_zk, argnums=0)
        return jax.vmap(jac)(zmat[..., :-1, :], zmat[..., 1:, :], ks)

    E, keep = _embedding(cols, dim, zmat.dtype)

    def res_r(wr, zk, zk1, k):
        zk = zk * keep + wr @ E
        return integrator.residual(layout, jnp.concatenate([zk, zk1]), k)

    jac = jax.jacfwd(res_r, argnums=0)
    Jr = jax.vmap(jac)(
        zmat[..., :-1, :] @ E.T, zmat[..., :-1, :], zmat[..., 1:, :], ks
    )  # (N-1, r, n_read)
    return Jr @ E


def stack_hessians_zk(
    integrator, layout: Layout, zmat: jax.Array, mu: jax.Array
) -> jax.Array:
    """Per-window Hessians of ``μ_k ⋅ residual_k`` w.r.t. ``z_k`` only:
    ``(N-1, dim, dim)`` — exact for explicit integrators (the residual is
    linear in ``z_{k+1}``, so all other Hessian quadrants vanish)."""
    dim = layout.dim
    ks = jnp.arange(layout.N - 1)

    import os

    # structure-exploiting per-integrator Hessian (the bilinear integrator's
    # linearity in x). OFF by default here: at z_k width the generic batched
    # forward-over-reverse is FASTER than the custom form's extra exp chains
    # (CPU B=8 QW build: 3.5 → 13.0 ms with it on) — it pays off only on the
    # 2·dim dense-window path (stack_hessians), which uses it directly.
    custom = getattr(integrator, "hessian_zk", None)
    if not os.environ.get("DTX_ZK_CUSTOM_HESS"):
        custom = None
    if custom is not None:
        return jax.vmap(lambda zk, zk1, k, m: custom(layout, zk, zk1, k, m))(
            zmat[..., :-1, :], zmat[..., 1:, :], ks, mu
        )

    # generic full-width AD by default (see _read_cols note)
    cols = _read_cols(integrator, layout) if os.environ.get("DTX_ZK_READCOLS") else None

    if cols is None:

        def lagr(zk, zk1, k, m):
            return jnp.dot(
                m, integrator.residual(layout, jnp.concatenate([zk, zk1]), k)
            )

        hess = jax.hessian(lagr, argnums=0)
        return jax.vmap(hess)(zmat[..., :-1, :], zmat[..., 1:, :], ks, mu)

    E, keep = _embedding(cols, dim, zmat.dtype)

    def lagr_r(wr, zk, zk1, k, m):
        zk = zk * keep + wr @ E
        return jnp.dot(m, integrator.residual(layout, jnp.concatenate([zk, zk1]), k))

    hess = jax.hessian(lagr_r, argnums=0)
    Hr = jax.vmap(hess)(
        zmat[..., :-1, :] @ E.T, zmat[..., :-1, :], zmat[..., 1:, :], ks, mu
    )  # (N-1, n_read, n_read)
    return jnp.einsum("kab,ad,be->kde", Hr, E, E)


def evaluate(integrator, traj: Trajectory) -> jax.Array:
    """Flat residual vector (x_dim*(N-1),) — analog of the reference's
    ``evaluate!`` (`src/integrators/bilinear_integrator.jl:98-107`)."""
    layout = traj.layout
    return stack_residuals(integrator, layout, traj.knot_matrix()).reshape(-1)
