"""Constraint interface and canonical lowering targets.

The reference splits constraints into *linear* ones (lowered directly to MOI
variable/affine constraints, `/root/reference/src/solvers/constrain.jl`) and
*nonlinear* ones (evaluated through the NLP callbacks,
`src/constraints/_constraints.jl:44-64`). The on-device solver has no MOI:
every linear constraint lowers into one canonical structure consumed by the
interior-point method directly:

* **pins** — coordinates of the flat decision vector fixed to values
  (initial/final conditions, EqualityConstraint). Handled by projection in
  the KKT solve (the analog of Ipopt's ``fixed_variable_treatment``).
* **box bounds** — per-coordinate ``lb ≤ Z ≤ ub`` (±inf allowed), handled by
  the log barrier.
* **affine equality rows** — ``A_eq Z = b_eq`` in static-sparsity COO form
  (symmetry, all-equal, total/duration, time-consistency, global-linear).
* **affine inequality rows** — ``A_in Z ≤ b_in`` (L1 slack, global-linear).

Nonlinear constraints expose pure per-knot functions with an ``equality``
flag (g=0 vs g≤0), differentiated by JAX AD instead of per-knot ForwardDiff.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..trajectory import Layout

__all__ = ["LinearCanon", "LinearConstraintBase", "NonlinearConstraintBase"]


@dataclass
class LinearCanon:
    """Accumulator for lowering linear constraints at trace time.

    Index arrays are numpy (static); value arrays are jnp (traced leaves).
    """

    z_dim: int
    # coordinate pins
    fix_idx: list = field(default_factory=list)  # np arrays of flat-Z indices
    fix_val: list = field(default_factory=list)  # jnp arrays of values
    # box bounds (intersection of all contributions)
    lb_idx: list = field(default_factory=list)
    lb_val: list = field(default_factory=list)
    ub_idx: list = field(default_factory=list)
    ub_val: list = field(default_factory=list)
    # affine rows, COO per contribution: (rows, cols) static, vals/rhs traced
    eq_rows: list = field(default_factory=list)  # (row_local, col, val, rhs, n_rows)
    ineq_rows: list = field(default_factory=list)  # same, sense: a·Z ≤ b

    def pin(self, idx: np.ndarray, vals) -> None:
        self.fix_idx.append(np.asarray(idx, dtype=np.int64))
        self.fix_val.append(jnp.asarray(vals, dtype=float).reshape(-1))

    def bound(self, idx: np.ndarray, lb, ub) -> None:
        idx = np.asarray(idx, dtype=np.int64)
        self.lb_idx.append(idx)
        self.lb_val.append(jnp.asarray(lb, dtype=float).reshape(-1))
        self.ub_idx.append(idx)
        self.ub_val.append(jnp.asarray(ub, dtype=float).reshape(-1))

    @staticmethod
    def _vals(vals):
        # keep statically-known coefficients as numpy: the Riccati backend's
        # chain-promotion analysis (in-core elimination) can only read static
        # values, and np arrays stay static under jit tracing
        if isinstance(vals, np.ndarray):
            return vals.astype(float).reshape(-1)
        return jnp.asarray(vals, dtype=float).reshape(-1)

    def add_eq_rows(self, rows, cols, vals, rhs, n_rows: int) -> None:
        self.eq_rows.append(
            (
                np.asarray(rows, dtype=np.int64),
                np.asarray(cols, dtype=np.int64),
                self._vals(vals),
                jnp.asarray(rhs, dtype=float).reshape(-1),
                int(n_rows),
            )
        )

    def add_ineq_rows(self, rows, cols, vals, rhs, n_rows: int) -> None:
        self.ineq_rows.append(
            (
                np.asarray(rows, dtype=np.int64),
                np.asarray(cols, dtype=np.int64),
                self._vals(vals),
                jnp.asarray(rhs, dtype=float).reshape(-1),
                int(n_rows),
            )
        )


class LinearConstraintBase:
    """Linear constraints implement ``lower(layout, canon)``."""

    def lower(self, layout: Layout, canon: LinearCanon) -> None:
        raise NotImplementedError


class NonlinearConstraintBase:
    """Nonlinear constraints: pure residual functions with an equality flag.

    Subtypes provide
      * ``constraint_dim(layout)`` — total residual length,
      * ``evaluate_flat(traj)`` — full residual vector, and
      * structured accessors used by the solver (per-knot / global terms).
    """

    equality: bool = True

    def constraint_dim(self, layout: Layout) -> int:
        raise NotImplementedError

    def evaluate_flat(self, traj) -> jax.Array:
        raise NotImplementedError
