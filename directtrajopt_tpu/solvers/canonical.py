"""Problem canonicalization: compile a DirectTrajOptProblem into NLP callables.

This is the JAX replacement for the reference's ``Evaluator``
(`/root/reference/src/solvers/evaluator.jl:99-289`): where the reference
concatenates sparsity patterns and builds linear index maps for MOI callbacks,
here the problem lowers (at trace time, from static metadata only) into

    min  f(Z)
    s.t. c_eq(Z) = 0      [dynamics ; affine rows A_eq Z − b_eq ; nonlinear eq]
         c_in(Z) ≤ 0      [affine rows A_in Z − b_in ; nonlinear ineq]
         lb ≤ Z ≤ ub      (±inf where unbounded)
         Z[fix_idx] = fix_val   (pins, handled by projection)

with every residual a pure, batched JAX function of the flat decision vector
``Z`` (reference layout ``[z_1; …; z_N; g]``). Derivatives are obtained by AD
in the solver; there is no sparsity bookkeeping to maintain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..constraints.base import LinearCanon, NonlinearConstraintBase
from ..integrators.base import stack_residuals
from ..problem import DirectTrajOptProblem
from ..trajectory import Layout

__all__ = ["COORows", "CanonicalNLP", "make_nlp"]


@dataclass
class COORows:
    """Affine constraint rows ``A Z − b`` in static-sparsity COO form.

    Dense (n_rows × z_dim) storage is O(N²·d) for the structured constraint
    zoo (N-row chains each touching a z_dim-wide row) — fine at N≈100,
    wrong-by-construction at N≈1000. Every consumer needs only matvec /
    rmatvec / a small row slice (the Riccati border), so the rows stay COO:
    ``rows``/``cols`` are static numpy (sparsity is structure), ``vals`` may
    be traced (constraint coefficients can be problem data).
    """

    rows: np.ndarray  # (nnz,) static
    cols: np.ndarray  # (nnz,) static
    vals: jax.Array  # (nnz,)
    n_rows: int
    n_cols: int

    def matvec(self, Z: jax.Array) -> jax.Array:
        """A @ Z."""
        out = jnp.zeros((self.n_rows,), dtype=Z.dtype)
        if len(self.rows) == 0:
            return out
        v = jnp.asarray(self.vals, dtype=Z.dtype)
        return out.at[jnp.asarray(self.rows)].add(v * Z[jnp.asarray(self.cols)])

    def rmatvec(self, y: jax.Array) -> jax.Array:
        """Aᵀ @ y."""
        out = jnp.zeros((self.n_cols,), dtype=y.dtype)
        if len(self.rows) == 0:
            return out
        v = jnp.asarray(self.vals, dtype=y.dtype)
        return out.at[jnp.asarray(self.cols)].add(v * y[jnp.asarray(self.rows)])

    def select_rows(self, idx: np.ndarray, dtype) -> jax.Array:
        """Dense (len(idx), n_cols) block of the selected rows (static idx).
        Used for the Riccati border, whose row count is O(1) in N."""
        idx = np.asarray(idx)
        keep = np.isin(self.rows, idx)
        remap = np.zeros(self.n_rows, dtype=np.int64)
        remap[idx] = np.arange(len(idx))
        out = jnp.zeros((len(idx), self.n_cols), dtype=dtype)
        if not keep.any():
            return out
        r = remap[self.rows[keep]]
        c = self.cols[keep]
        v = jnp.asarray(self.vals, dtype=dtype)[jnp.asarray(np.nonzero(keep)[0])]
        return out.at[jnp.asarray(r), jnp.asarray(c)].add(v)

    def dense(self, dtype) -> jax.Array:
        """Full dense materialization (dense-backend assembly only)."""
        out = jnp.zeros((self.n_rows, self.n_cols), dtype=dtype)
        if len(self.rows) == 0:
            return out
        return out.at[jnp.asarray(self.rows), jnp.asarray(self.cols)].add(
            jnp.asarray(self.vals, dtype=dtype)
        )


@dataclass
class CanonicalNLP:
    """Trace-time NLP view of a problem. Holds closures over problem leaves."""

    layout: Layout
    z_dim: int
    n_dyn: int  # dynamics equality rows
    n_lin_eq: int
    n_nl_eq: int
    n_lin_in: int
    n_nl_in: int
    # pins
    fix_idx: np.ndarray  # static coordinate indices (unique)
    fix_val: jax.Array  # (len(fix_idx),)
    free_mask: jax.Array  # (z_dim,) 1.0 where free, 0.0 where pinned
    pin_dense: jax.Array  # (z_dim,) fix_val scattered dense, 0.0 where free
    # bounds (pinned coords forced to ±inf → no barrier)
    lb: jax.Array
    ub: jax.Array
    # affine rows (COO — see COORows)
    A_eq: "COORows"
    b_eq: jax.Array
    A_in: "COORows"
    b_in: jax.Array
    # callables
    objective: Callable  # (Z,) -> scalar
    dynamics: Callable  # (Z,) -> (n_dyn,)
    nl_eq: Callable  # (Z,) -> (n_nl_eq,)
    nl_in: Callable  # (Z,) -> (n_nl_in,)
    # component references for structured derivative assembly
    integrators: tuple = ()
    objective_obj: object = None
    eq_cons: tuple = ()
    in_cons: tuple = ()
    traj: object = None
    # raw COO contributions from linear-constraint lowering (static sparsity),
    # kept for the structured (Riccati) backend's eligibility analysis and
    # per-knot block extraction
    eq_entries: tuple = ()
    in_entries: tuple = ()

    @property
    def n_eq(self) -> int:
        return self.n_dyn + self.n_lin_eq + self.n_nl_eq

    @property
    def n_in(self) -> int:
        return self.n_lin_in + self.n_nl_in

    def c_eq(self, Z: jax.Array) -> jax.Array:
        parts = [self.dynamics(Z)]
        if self.n_lin_eq:
            parts.append(self.A_eq.matvec(Z) - self.b_eq)
        if self.n_nl_eq:
            parts.append(self.nl_eq(Z))
        return jnp.concatenate(parts) if parts else jnp.zeros((0,), dtype=Z.dtype)

    def c_eq_l1(self, Z: jax.Array) -> jax.Array:
        """``Σ|c_eq(Z)|`` without concatenating the residual vector — the
        line-search θ consumer reduces each part separately."""
        from ..integrators.base import stack_residuals_l1

        zmat = Z[: self.layout.N * self.layout.dim].reshape(
            self.layout.N, self.layout.dim
        )
        tot = jnp.zeros((), dtype=Z.dtype)
        for integ in self.integrators:
            tot = tot + stack_residuals_l1(integ, self.layout, zmat)
        if self.n_lin_eq:
            tot = tot + jnp.sum(jnp.abs(self.A_eq.matvec(Z) - self.b_eq))
        if self.n_nl_eq:
            tot = tot + jnp.sum(jnp.abs(self.nl_eq(Z)))
        return tot

    def c_in(self, Z: jax.Array) -> jax.Array:
        parts = []
        if self.n_lin_in:
            parts.append(self.A_in.matvec(Z) - self.b_in)
        if self.n_nl_in:
            parts.append(self.nl_in(Z))
        return (
            jnp.concatenate(parts) if parts else jnp.zeros((0,), dtype=Z.dtype)
        )

    def apply_pins(self, Z: jax.Array) -> jax.Array:
        """Overwrite pinned coordinates with their fixed values.

        Mask multiply-add, NOT ``Z.at[idx].set``: an index-array scatter per
        call, and this runs ~14×/IPM-iteration (every line-search trial). The dense pin vector is built once at
        make_nlp time; here it's two fusable elementwise ops."""
        if len(self.fix_idx) == 0:
            return Z
        return Z * self.free_mask.astype(Z.dtype) + self.pin_dense.astype(Z.dtype)


def make_nlp(problem: DirectTrajOptProblem, dtype=None) -> CanonicalNLP:
    """Lower a problem to canonical NLP form. Runs at trace time: all index
    computation uses static metadata; closures capture problem leaves."""
    traj = problem.trajectory
    layout = traj.layout
    z_dim = layout.z_dim
    if dtype is None:
        dtype = traj.knot_matrix().dtype

    # ---- linear constraints → canonical pins/bounds/rows ---------------- #
    canon = LinearCanon(z_dim=z_dim)
    nl_cons: list[NonlinearConstraintBase] = []
    for con in problem.constraints:
        if isinstance(con, NonlinearConstraintBase):
            nl_cons.append(con)
        else:
            con.lower(layout, canon)

    # pins: later contributions override earlier ones
    if canon.fix_idx:
        all_idx = np.concatenate(canon.fix_idx)
        uniq, inverse = np.unique(all_idx, return_inverse=True)
        vals = jnp.zeros((len(uniq),), dtype=dtype)
        pos = 0
        for idx_arr, val_arr in zip(canon.fix_idx, canon.fix_val):
            n = len(idx_arr)
            vals = vals.at[jnp.asarray(inverse[pos : pos + n])].set(
                val_arr.astype(dtype)
            )
            pos += n
        fix_idx, fix_val = uniq, vals
    else:
        fix_idx = np.zeros((0,), dtype=np.int64)
        fix_val = jnp.zeros((0,), dtype=dtype)

    free_mask = jnp.ones((z_dim,), dtype=dtype).at[jnp.asarray(fix_idx)].set(0.0) \
        if len(fix_idx) else jnp.ones((z_dim,), dtype=dtype)

    # bounds: intersection (max of lbs / min of ubs); pinned coords excluded
    lb = jnp.full((z_dim,), -jnp.inf, dtype=dtype)
    ub = jnp.full((z_dim,), jnp.inf, dtype=dtype)
    for idx, val in zip(canon.lb_idx, canon.lb_val):
        lb = lb.at[jnp.asarray(idx)].max(val.astype(dtype))
    for idx, val in zip(canon.ub_idx, canon.ub_val):
        ub = ub.at[jnp.asarray(idx)].min(val.astype(dtype))
    if len(fix_idx):
        fi = jnp.asarray(fix_idx)
        lb = lb.at[fi].set(-jnp.inf)
        ub = ub.at[fi].set(jnp.inf)

    # affine rows → one concatenated COO block (dense (rows × z_dim) storage
    # is O(N²·d) for chain constraints; consumers only need matvecs)
    def build_rows(entries):
        n_rows = sum(e[4] for e in entries)
        all_rows, all_cols, all_vals = [], [], []
        b = jnp.zeros((n_rows,), dtype=dtype)
        off = 0
        for rows, cols, vals, rhs, n in entries:
            all_rows.append(np.asarray(rows) + off)
            all_cols.append(np.asarray(cols))
            all_vals.append(jnp.asarray(vals, dtype=dtype))
            b = b.at[off : off + n].set(rhs.astype(dtype))
            off += n
        A = COORows(
            rows=np.concatenate(all_rows) if all_rows else np.zeros(0, np.int64),
            cols=np.concatenate(all_cols) if all_cols else np.zeros(0, np.int64),
            vals=jnp.concatenate(all_vals) if all_vals else jnp.zeros(0, dtype),
            n_rows=n_rows,
            n_cols=z_dim,
        )
        return A, b, n_rows

    A_eq, b_eq, n_lin_eq = build_rows(canon.eq_rows)
    A_in, b_in, n_lin_in = build_rows(canon.ineq_rows)

    # ---- dynamics ------------------------------------------------------- #
    integrators = problem.integrators
    n_dyn = sum(i.residual_dim(layout) for i in integrators) * (layout.N - 1)

    def dynamics(Z):
        zmat = Z[: layout.N * layout.dim].reshape(layout.N, layout.dim)
        parts = [
            stack_residuals(integ, layout, zmat).reshape(-1)
            for integ in integrators
        ]
        return (
            jnp.concatenate(parts) if parts else jnp.zeros((0,), dtype=Z.dtype)
        )

    # ---- nonlinear constraints ------------------------------------------ #
    eq_cons = [c for c in nl_cons if c.equality]
    in_cons = [c for c in nl_cons if not c.equality]
    n_nl_eq = sum(c.constraint_dim(layout) for c in eq_cons)
    n_nl_in = sum(c.constraint_dim(layout) for c in in_cons)

    def _eval_group(cons, Z):
        tr = traj.from_zvec(Z)
        return jnp.concatenate([c.evaluate_flat(tr) for c in cons])

    def nl_eq(Z):
        return _eval_group(eq_cons, Z)

    def nl_in(Z):
        return _eval_group(in_cons, Z)

    # ---- objective ------------------------------------------------------ #
    from ..objectives.base import objective_value

    def objective(Z):
        return objective_value(problem.objective, traj.from_zvec(Z))

    return CanonicalNLP(
        layout=layout,
        z_dim=z_dim,
        n_dyn=n_dyn,
        n_lin_eq=n_lin_eq,
        n_nl_eq=n_nl_eq,
        n_lin_in=n_lin_in,
        n_nl_in=n_nl_in,
        fix_idx=fix_idx,
        fix_val=fix_val,
        free_mask=free_mask,
        pin_dense=(
            jnp.zeros((z_dim,), dtype=dtype).at[jnp.asarray(fix_idx)].set(fix_val)
            if len(fix_idx)
            else jnp.zeros((z_dim,), dtype=dtype)
        ),
        lb=lb,
        ub=ub,
        A_eq=A_eq,
        b_eq=b_eq,
        A_in=A_in,
        b_in=b_in,
        objective=objective,
        dynamics=dynamics,
        nl_eq=nl_eq,
        nl_in=nl_in,
        integrators=tuple(integrators),
        objective_obj=problem.objective,
        eq_cons=tuple(eq_cons),
        in_cons=tuple(in_cons),
        traj=traj,
        eq_entries=tuple(canon.eq_rows),
        in_entries=tuple(canon.ineq_rows),
    )
