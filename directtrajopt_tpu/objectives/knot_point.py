"""User-defined knot-point objectives.

``KnotPointObjective``: ``J = Σ_{k∈times} Q_k ℓ(vars_k, p_k)`` where ℓ is a
user scalar function of the concatenated named variables at a knot, optionally
taking per-time parameters (`/root/reference/src/objectives/knot_point_objectives.jl:65-157`).
``TerminalObjective`` is the ``times=[N]`` special case. Derivatives come from
JAX AD instead of per-knot ForwardDiff.

The per-knot Hessian-vector-product capability the reference declares through
``KnotHVP`` carriers (`src/objectives/knot_hvp.jl:45-152`) is free here:
:func:`knot_hvp` applies ``jax.jvp(jax.grad(ℓ))``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..module import module, static_field
from ..trajectory import Layout, Trajectory
from .base import ObjectiveBase
from .regularizers import times_mask

__all__ = ["KnotPointObjective", "TerminalObjective", "knot_hvp"]


@module
class KnotPointObjective(ObjectiveBase):
    """``Σ_k Q_k ℓ(vars_k, p_k)`` over selected knots."""

    Qs: jax.Array  # (N,) weights (zero off-times)
    params: jax.Array | None  # (N, ...) per-knot parameters or None
    hvp_carrier: object | None  # declared KnotHVP capability (API parity)
    ell: Callable = static_field()
    var_names: tuple[str, ...] = static_field()
    takes_params: bool = static_field(default=False)

    @staticmethod
    def create(
        ell: Callable,
        names: str | Sequence[str],
        traj: Trajectory,
        params: Sequence | None = None,
        *,
        times: Sequence[int] | None = None,
        Qs: Sequence[float] | None = None,
        knot_hvp=None,
    ) -> "KnotPointObjective":
        if isinstance(names, str):
            names = (names,)
        names = tuple(names)
        N = traj.N
        t_idx = np.arange(N) if times is None else np.asarray(times, dtype=int)
        mask = times_mask(N, t_idx)
        q_full = np.zeros(N)
        q_full[t_idx] = np.ones(len(t_idx)) if Qs is None else np.asarray(Qs, dtype=float)

        params_full = None
        takes_params = params is not None
        if takes_params:
            p_arr = np.stack([np.asarray(p, dtype=float) for p in params])
            # scatter per-time params into a full (N, ...) array (off-time rows
            # are multiplied by zero weight, so their content is irrelevant)
            full_shape = (N,) + p_arr.shape[1:]
            params_full = np.zeros(full_shape)
            params_full[np.asarray(t_idx)] = p_arr

        return KnotPointObjective(
            Qs=np.asarray(q_full * mask),
            params=params_full,
            hvp_carrier=knot_hvp,
            ell=ell,
            var_names=names,
            takes_params=takes_params,
        )

    def _vars(self, layout: Layout, z):
        return jnp.concatenate(
            [layout.knot_extract(z, name) for name in self.var_names], axis=-1
        )

    def cost_at_knot(self, layout: Layout, z, g, k):
        vals = self._vars(layout, z)
        # jnp.asarray: numpy data leaves cannot be indexed by the traced k
        if self.takes_params:
            cost = self.ell(vals, jnp.asarray(self.params)[k])
        else:
            cost = self.ell(vals)
        return jnp.asarray(self.Qs)[k] * cost

    def __repr__(self):
        return f"KnotPointObjective on {list(self.var_names)}"


def TerminalObjective(
    ell: Callable,
    names: str | Sequence[str],
    traj: Trajectory,
    *,
    Q: float = 1.0,
    params: Sequence | None = None,
) -> KnotPointObjective:
    """Objective applied at the final knot only
    (`src/objectives/knot_point_objectives.jl:123-157`)."""
    return KnotPointObjective.create(
        ell,
        names,
        traj,
        params,
        times=[traj.N - 1],
        Qs=[Q],
    )


def knot_hvp(obj: KnotPointObjective, layout: Layout, z, g, k, v):
    """Matrix-free per-knot Hessian-vector product ``∇²_z cost_at_knot · v``.

    The on-device realization of the reference's declarable ``KnotHVP``
    capability (`src/objectives/knot_hvp.jl`): on-device, exact, and free —
    forward-over-reverse through the knot cost.
    """
    grad_fn = jax.grad(lambda zz: obj.cost_at_knot(layout, zz, g, k))
    return jax.jvp(grad_fn, (z,), (v,))[1]
