"""Bilinear integrator: exact discretization of control-linear dynamics.

Dynamics residual (cf. /root/reference/src/integrators/bilinear_integrator.jl:48,81):

    x_{k+1} − exp(Δt_k · G(u_k)) · x_k = 0

The system matrix can be given either as arrays ``G(u) = G_drift + Σᵢ uᵢ G_drives[i]``
(stored as pytree leaves, so a vmapped batch of problems may carry *different*
dynamics parameters per scenario) or as an arbitrary Python callable
``G(u) -> (x_dim, x_dim)`` (static, closed over constants).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..module import module, static_field
from ..ops.expm import expm_pade, expv_taylor
from ..trajectory import Layout, Trajectory

__all__ = ["BilinearIntegrator"]


@module
class BilinearIntegrator:
    """``x_{k+1} = exp(Δt G(u_k)) x_k`` dynamics constraint.

    ``explicit=True``: the residual has the form ``x_{k+1} − F(z_k)`` (linear
    identity coupling to the next knot), which the Riccati KKT backend
    exploits for exact stage-wise elimination.
    """

    explicit = True

    G_drift: jax.Array | None
    G_drives: jax.Array | None  # (u_dim, x_dim, x_dim)
    x_name: str = static_field()
    u_name: str = static_field()
    G_fn: Callable | None = static_field(default=None)
    squarings: int = static_field(default=4)
    # "pade" (general) or "taylor" (matvec action; fastest when ‖Δt·G‖ ≲ 1)
    method: str = static_field(default="pade")
    taylor_order: int = static_field(default=12)

    @staticmethod
    def create(
        G,
        x_name: str,
        u_name: str,
        traj: Trajectory | Layout | None = None,
        *,
        squarings: int = 4,
        method: str = "pade",
        taylor_order: int = 12,
    ) -> "BilinearIntegrator":
        """Build from a callable ``G(u)`` or a ``(G_drift, G_drives)`` pair."""
        if callable(G):
            return BilinearIntegrator(
                G_drift=None,
                G_drives=None,
                x_name=x_name,
                u_name=u_name,
                G_fn=G,
                squarings=squarings,
                method=method,
                taylor_order=taylor_order,
            )
        G_drift, G_drives = G
        # host-side (numpy) leaves: no eager device ops at problem build,
        # and no device-constant fetches when a rollout/solve closure
        # captures the integrator (see trajectory._as_component_array)
        import numpy as np

        drives = np.stack([np.asarray(Gi, dtype=float) for Gi in G_drives])
        return BilinearIntegrator(
            G_drift=np.asarray(G_drift, dtype=float),
            G_drives=drives,
            x_name=x_name,
            u_name=u_name,
            G_fn=None,
            squarings=squarings,
            method=method,
            taylor_order=taylor_order,
        )

    def system_matrix(self, u: jax.Array) -> jax.Array:
        if self.G_fn is not None:
            return jnp.asarray(self.G_fn(u))
        return self.G_drift + jnp.tensordot(u, self.G_drives, axes=1)

    def residual_dim(self, layout: Layout) -> int:
        return layout.dim_of(self.x_name)

    def read_cols(self, layout: Layout):
        """z_k columns the residual reads (x, u, Δt) — restricts window AD."""
        cs_x, cs_u = layout.comp_slice(self.x_name), layout.comp_slice(self.u_name)
        cols = list(range(cs_x.start, cs_x.stop)) + list(range(cs_u.start, cs_u.stop))
        if layout.has_free_time:
            cols.append(layout.offsets[layout.timestep])
        return cols

    def _apply(self, u, dt, v, transpose=False):
        """``exp(Δt·G(u)) v`` (or the adjoint action with ``transpose``)."""
        A = dt * self.system_matrix(u)
        if transpose:
            A = A.T
        if self.method == "taylor":
            return expv_taylor(A, v, order=self.taylor_order)
        return expm_pade(A, squarings=self.squarings) @ v

    def hessian_zk(self, layout: Layout, zk, zk1, k, m):
        """Structure-exploiting Hessian of ``mᵀ residual`` w.r.t. ``z_k``.

        The residual ``x_{k+1} − E(u,Δt)·x`` is *linear in x*, so with
        θ = (u, Δt): H_xx = 0, H_xθ = −∂_θ(E(θ)ᵀm) (a 3-tangent jacfwd of the
        adjoint action), H_θθ = −∂²_θ(mᵀE(θ)x) (3×3 AD pairs) — versus
        (x+u+Δt)² generic AD pairs through the exp chain. Same values, ~4×
        less prepare-stage work (the IPM's dominant per-iteration cost).
        """
        import numpy as np

        d = layout.dim
        dtype = zk.dtype
        cs_x = layout.comp_slice(self.x_name)
        cs_u = layout.comp_slice(self.u_name)
        x = zk[cs_x]
        u = zk[cs_u]
        free_t = layout.has_free_time
        th_cols = list(range(cs_u.start, cs_u.stop))
        if free_t:
            th_cols.append(layout.offsets[layout.timestep])
            th0 = jnp.concatenate([u, zk[layout.offsets[layout.timestep]][None]])
        else:
            th0 = u

        def split(th):
            if free_t:
                return th[:-1], th[-1]
            return th, layout.knot_timestep(zk, dtype=dtype)

        def ETm(th):
            u_, dt_ = split(th)
            return self._apply(u_, dt_, m, transpose=True)

        def mEx(th):
            u_, dt_ = split(th)
            return jnp.dot(m, self._apply(u_, dt_, x))

        Hxt = -jax.jacfwd(ETm)(th0)  # (x_dim, n_th)
        Htt = -jax.hessian(mEx)(th0)  # (n_th, n_th)
        # scatter into (d, d) via static one-hot embeddings (tiny matmuls
        # instead of index-array scatters)
        Ex = np.zeros((cs_x.stop - cs_x.start, d))
        Ex[np.arange(cs_x.stop - cs_x.start), np.arange(cs_x.start, cs_x.stop)] = 1.0
        Et = np.zeros((len(th_cols), d))
        Et[np.arange(len(th_cols)), th_cols] = 1.0
        Ex = jnp.asarray(Ex, dtype=dtype)
        Et = jnp.asarray(Et, dtype=dtype)
        Hxt_full = Ex.T @ Hxt @ Et  # (d, d)
        return Hxt_full + Hxt_full.T + Et.T @ Htt @ Et

    def residuals_stacked(self, layout: Layout, zmat: jax.Array):
        """Closed-form stacked residuals ``x_{k+1} − E(u_k,Δt_k)x_k`` for all
        windows (``ops/expv_kernel.py``) — the line-search trial grid is the
        hottest c_eq consumer. None when ineligible.

        f32 only: f64 call sites (the refine-residuals passes that
        ``jax.vjp`` c_eq in ``ipm.py``, the f64 goldens) keep the generic
        per-window path."""
        if (
            self.G_fn is not None
            or self.method != "taylor"
            or zmat.dtype != jnp.float32
        ):
            return None
        from ..ops.expv_kernel import make_residual_action

        dtype = zmat.dtype
        cs_x = layout.comp_slice(self.x_name)
        cs_u = layout.comp_slice(self.u_name)
        x = zmat[:-1, cs_x]
        xn = zmat[1:, cs_x]
        u = zmat[:-1, cs_u]
        if layout.has_free_time:
            dt = zmat[:-1, layout.offsets[layout.timestep]]
        else:
            dt = jnp.full((zmat.shape[0] - 1,), layout.timestep, dtype=dtype)
        return make_residual_action(self.taylor_order)(
            self.G_drift.astype(dtype), self.G_drives.astype(dtype),
            u, dt, x, xn,
        )

    def jacobians_zk_stacked(self, layout: Layout, zmat: jax.Array):
        """Closed-form stacked ``∂residual/∂z_k`` (``ops/expv_kernel.py``) in
        place of generic window AD in the IPM's prepare stage.
        Returns None when ineligible (callable G, Padé method) so the caller
        falls back to generic window AD."""
        import numpy as np

        if self.G_fn is not None or self.method != "taylor":
            return None
        from ..ops.expv_kernel import make_window_jac

        dim = layout.dim
        dtype = zmat.dtype
        cs_x = layout.comp_slice(self.x_name)
        cs_u = layout.comp_slice(self.u_name)
        free_t = bool(layout.has_free_time)
        x = zmat[:-1, cs_x]
        u = zmat[:-1, cs_u]
        if free_t:
            dt = zmat[:-1, layout.offsets[layout.timestep]]
        else:
            dt = jnp.full((zmat.shape[0] - 1,), layout.timestep, dtype=dtype)
        J = make_window_jac(self.taylor_order, free_t)(
            self.G_drift.astype(dtype), self.G_drives.astype(dtype), u, dt, x
        )  # (N-1, xd, n_th) = ∂(E x)/∂(x, u[, Δt])
        # scatter the window columns into z_k width via a static one-hot
        # (one tiny matmul instead of an index scatter)
        cols = list(range(cs_x.start, cs_x.stop)) + list(
            range(cs_u.start, cs_u.stop)
        )
        if free_t:
            cols.append(layout.offsets[layout.timestep])
        Em = np.zeros((len(cols), dim))
        Em[np.arange(len(cols)), cols] = 1.0
        return -(J @ jnp.asarray(Em, dtype=dtype))

    def residual(self, layout: Layout, w: jax.Array, k: jax.Array) -> jax.Array:
        dim = layout.dim
        zk, zk1 = w[:dim], w[dim:]
        x = layout.knot_extract(zk, self.x_name)
        x_next = layout.knot_extract(zk1, self.x_name)
        u = layout.knot_extract(zk, self.u_name)
        dt = layout.knot_timestep(zk, dtype=w.dtype)
        G = self.system_matrix(u)
        if self.method == "taylor":
            return x_next - expv_taylor(dt * G, x, order=self.taylor_order)
        return x_next - expm_pade(dt * G, squarings=self.squarings) @ x

    def __repr__(self) -> str:
        return (
            f"BilinearIntegrator: {self.x_name} = "
            f"exp(Δt G({self.u_name})) {self.x_name}"
        )
