"""Trajectory data model — the JAX `NamedTrajectory`.

Replaces the reference's external data layer (NamedTrajectories.jl +
TrajectoryIndexingUtils.jl; see /root/reference/CONTEXT.md:146-162 and usage
at /root/reference/src/problems.jl:13-14) with a JAX pytree:

* each named component is an ``(N, dim)`` array (knot axis leading, so the
  whole trajectory vmaps/shards naturally over a scenario batch axis),
* per-problem numeric metadata (initial / final / goal values, bounds) are
  pytree leaves too, so a batch of problems differing only in data (e.g.
  goals) is just a stacked Trajectory,
* structural metadata (component names/order, timestep spec, control names)
  is static and lives in a hashable :class:`Layout` that index-maps the
  per-knot vector — the analog of ``traj.components`` /
  ``slice(k, comps, dim)`` in the reference.

Flat-vector interop: ``to_zvec``/``from_zvec`` use the reference layout
``Z = [z_1; …; z_N; g]`` with each knot stacking components in declaration
order (cf. `src/objectives/_objectives.jl:135`), which tests and the dense
KKT path rely on.
"""

from __future__ import annotations

from functools import cached_property
from typing import Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .module import module, static_field

__all__ = ["Layout", "Trajectory", "traj_slice", "traj_index"]


def traj_slice(k: int, dim: int, comps: slice | None = None):
    """0-based analog of TrajectoryIndexingUtils.slice: indices of knot ``k``.

    ``traj_slice(k, dim)`` → ``slice(k*dim, (k+1)*dim)``;
    ``traj_slice(k, dim, comps)`` restricts to the component sub-slice.
    """
    base = k * dim
    if comps is None:
        return slice(base, base + dim)
    return slice(base + comps.start, base + comps.stop)


def traj_index(k: int, comp: int, dim: int) -> int:
    """0-based analog of TrajectoryIndexingUtils.index."""
    return k * dim + comp


@module
class Layout:
    """Static index map for a trajectory's knot vector and global block."""

    names: tuple[str, ...] = static_field()
    dims: tuple[int, ...] = static_field()
    N: int = static_field()
    timestep: str | float = static_field()
    controls: tuple[str, ...] = static_field(default=())
    global_names: tuple[str, ...] = static_field(default=())
    global_dims: tuple[int, ...] = static_field(default=())

    @cached_property
    def dim(self) -> int:
        """Per-knot vector dimension (the reference's ``traj.dim``)."""
        return sum(self.dims)

    @cached_property
    def global_dim(self) -> int:
        return sum(self.global_dims)

    @cached_property
    def z_dim(self) -> int:
        """Total decision dimension ``N * dim + global_dim``."""
        return self.N * self.dim + self.global_dim

    @cached_property
    def offsets(self) -> dict[str, int]:
        out, o = {}, 0
        for name, d in zip(self.names, self.dims):
            out[name] = o
            o += d
        return out

    @cached_property
    def global_offsets(self) -> dict[str, int]:
        out, o = {}, 0
        for name, d in zip(self.global_names, self.global_dims):
            out[name] = o
            o += d
        return out

    def dim_of(self, name: str) -> int:
        if name in self.offsets:
            return self.dims[self.names.index(name)]
        return self.global_dims[self.global_names.index(name)]

    def comp_slice(self, name: str) -> slice:
        """Index range of component ``name`` within one knot vector."""
        o = self.offsets[name]
        return slice(o, o + self.dim_of(name))

    def global_slice(self, name: str) -> slice:
        """Index range of global component ``name`` within the global block."""
        o = self.global_offsets[name]
        return slice(o, o + self.dim_of(name))

    def z_slice(self, k: int, name: str) -> slice:
        """Index range of component ``name`` at knot ``k`` in flat Z."""
        cs = self.comp_slice(name)
        return slice(k * self.dim + cs.start, k * self.dim + cs.stop)

    def global_z_slice(self, name: str) -> slice:
        """Index range of global ``name`` in flat Z (after all knots)."""
        gs = self.global_slice(name)
        base = self.N * self.dim
        return slice(base + gs.start, base + gs.stop)

    @property
    def has_free_time(self) -> bool:
        return isinstance(self.timestep, str)

    def knot_extract(self, z: jax.Array, name: str) -> jax.Array:
        """Extract component ``name`` from a knot vector ``z`` of shape (dim,)."""
        return z[..., self.comp_slice(name)]

    def knot_timestep(self, z: jax.Array, dtype=None) -> jax.Array:
        """Scalar Δt at a knot: component value if free time, constant else."""
        if self.has_free_time:
            return z[..., self.offsets[self.timestep]]
        return jnp.asarray(self.timestep, dtype=dtype if dtype is not None else z.dtype)


def _as_component_array(value, N: int | None = None):
    # HOST-side construction (r4): problem building stays in numpy — no
    # eager device ops, no device-array constants captured into later jit
    # traces (each such constant costs a device→host fetch at lowering).
    # Leaves are device-put
    # once, when the problem pytree is passed to a jitted solve. Tracers
    # pass through so create() also works under jit.
    if isinstance(value, jax.Array):  # device data/tracers: leave in place
        arr = value
    else:
        arr = np.asarray(value, dtype=np.float64)
    if arr.ndim == 1 and N is not None:
        arr = arr[:, None]  # (N,) -> (N, 1)
    return arr


def _normalize_bound(bound, dim: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Normalize a bound spec to (lb, ub) vectors of shape (dim,).

    Accepts scalar ``s`` (→ symmetric ±|s|), a (lb, ub) pair of
    scalars/vectors, or a (dim, 2) array — mirroring the reference's
    BoundsConstraint forms (`src/constraints/linear/bounds_constraint.jl:22-91`).
    """
    if isinstance(bound, tuple) and len(bound) == 2:
        lb = np.broadcast_to(np.asarray(bound[0], dtype=float), (dim,))
        ub = np.broadcast_to(np.asarray(bound[1], dtype=float), (dim,))
        return lb, ub
    arr = np.asarray(bound, dtype=float)
    if arr.ndim == 0:
        s = abs(float(arr))
        return np.full((dim,), -s), np.full((dim,), s)
    if arr.ndim == 1:
        v = np.abs(arr)
        return -v, v
    if arr.ndim == 2 and arr.shape == (dim, 2):
        return arr[:, 0], arr[:, 1]
    raise ValueError(f"cannot interpret bound spec with shape {arr.shape} for dim {dim}")


@module
class Trajectory:
    """Named per-knot variables + global block, with problem metadata.

    Leaves: ``data[name] → (N, dim_name)``, ``global_data[name] → (g_dim,)``,
    ``initial/final/goal[name] → (dim_name,)``, ``bounds[name] → (lb, ub)``
    each ``(dim_name,)``. Static: names order, timestep spec, controls.
    """

    data: dict[str, jax.Array]
    global_data: dict[str, jax.Array]
    initial: dict[str, jax.Array]
    final: dict[str, jax.Array]
    goal: dict[str, jax.Array]
    bounds: dict[str, tuple[jax.Array, jax.Array]]
    names: tuple[str, ...] = static_field()
    global_names: tuple[str, ...] = static_field(default=())
    timestep: str | float = static_field(default=1.0)
    controls: tuple[str, ...] = static_field(default=())

    # ------------------------------------------------------------------ #
    # Construction
    # ------------------------------------------------------------------ #

    @staticmethod
    def create(
        data: Mapping[str, jax.Array],
        *,
        timestep: str | float,
        controls: str | Sequence[str] = (),
        initial: Mapping[str, jax.Array] | None = None,
        final: Mapping[str, jax.Array] | None = None,
        goal: Mapping[str, jax.Array] | None = None,
        bounds: Mapping[str, object] | None = None,
        global_data: Mapping[str, jax.Array] | None = None,
    ) -> "Trajectory":
        names = tuple(data.keys())
        arrs: dict[str, jnp.ndarray] = {}
        N = None
        for name in names:
            arr = _as_component_array(data[name])
            if arr.ndim == 1:
                arr = arr[:, None]
            if N is None:
                N = arr.shape[0]
            elif arr.shape[0] != N:
                raise ValueError(
                    f"component {name!r} has {arr.shape[0]} knots, expected {N}"
                )
            arrs[name] = arr
        assert N is not None, "trajectory needs at least one component"

        if isinstance(timestep, str) and timestep not in names:
            raise ValueError(f"timestep component {timestep!r} not in data")
        if isinstance(controls, str):
            controls = (controls,)
        controls = tuple(controls)
        for c in controls:
            if c not in names:
                raise ValueError(f"control {c!r} not in data")

        gdata = {
            k: _as_component_array(v).reshape(-1)
            for k, v in (global_data or {}).items()
        }

        def _fixed(m: Mapping[str, jax.Array] | None) -> dict[str, jnp.ndarray]:
            out = {}
            for k, v in (m or {}).items():
                if k not in names:
                    raise ValueError(f"metadata references unknown component {k!r}")
                out[k] = _as_component_array(v).reshape(-1)
            return out

        bnds = {}
        for k, v in (bounds or {}).items():
            if k not in names and k not in gdata:
                raise ValueError(f"bounds reference unknown component {k!r}")
            d = arrs[k].shape[1] if k in names else gdata[k].shape[0]
            bnds[k] = _normalize_bound(v, d)

        return Trajectory(
            data=arrs,
            global_data=gdata,
            initial=_fixed(initial),
            final=_fixed(final),
            goal=_fixed(goal),
            bounds=bnds,
            names=names,
            global_names=tuple(gdata.keys()),
            timestep=timestep,
            controls=controls,
        )

    # ------------------------------------------------------------------ #
    # Structure
    # ------------------------------------------------------------------ #

    @property
    def N(self) -> int:
        return self.data[self.names[0]].shape[-2]

    @property
    def dims(self) -> dict[str, int]:
        d = {name: self.data[name].shape[-1] for name in self.names}
        d.update({name: self.global_data[name].shape[-1] for name in self.global_names})
        return d

    @property
    def dim(self) -> int:
        return sum(self.data[name].shape[-1] for name in self.names)

    @property
    def global_dim(self) -> int:
        return sum(self.global_data[name].shape[-1] for name in self.global_names)

    @property
    def layout(self) -> Layout:
        return Layout(
            names=self.names,
            dims=tuple(self.data[name].shape[-1] for name in self.names),
            N=self.N,
            timestep=self.timestep,
            controls=self.controls,
            global_names=self.global_names,
            global_dims=tuple(
                self.global_data[name].shape[-1] for name in self.global_names
            ),
        )

    # ------------------------------------------------------------------ #
    # Flat-vector interop (reference layout Z = [z_1; …; z_N; g])
    # ------------------------------------------------------------------ #

    def knot_matrix(self) -> jnp.ndarray:
        """Stack all components into an ``(N, dim)`` matrix (knot rows)."""
        return jnp.concatenate([self.data[name] for name in self.names], axis=-1)

    def to_zvec(self) -> jnp.ndarray:
        """Flatten to the reference decision-vector layout ``[z_1; …; z_N; g]``."""
        z = self.knot_matrix().reshape(*self.knot_matrix().shape[:-2], -1)
        if self.global_names:
            g = jnp.concatenate(
                [self.global_data[name] for name in self.global_names], axis=-1
            )
            z = jnp.concatenate([z, g], axis=-1)
        return z

    def from_zvec(self, z: jax.Array) -> "Trajectory":
        """Rebuild a trajectory with data taken from a flat decision vector."""
        layout = self.layout
        lead = z.shape[:-1]
        zmat = z[..., : layout.N * layout.dim].reshape(*lead, layout.N, layout.dim)
        data = {
            name: zmat[..., layout.comp_slice(name)] for name in self.names
        }
        gvec = z[..., layout.N * layout.dim :]
        global_data = {
            name: gvec[..., layout.global_slice(name)] for name in self.global_names
        }
        return self.replace(data=data, global_data=global_data)

    def from_knot_matrix(self, zmat: jax.Array, gvec: jax.Array | None = None) -> "Trajectory":
        layout = self.layout
        data = {name: zmat[..., layout.comp_slice(name)] for name in self.names}
        global_data = self.global_data
        if gvec is not None and self.global_names:
            global_data = {
                name: gvec[..., layout.global_slice(name)] for name in self.global_names
            }
        return self.replace(data=data, global_data=global_data)

    # ------------------------------------------------------------------ #
    # Time helpers (NamedTrajectories.get_times / get_duration analogs)
    # ------------------------------------------------------------------ #

    def timesteps(self) -> jnp.ndarray:
        """Per-knot Δt values, shape (N,)."""
        if isinstance(self.timestep, str):
            return self.data[self.timestep][..., 0]
        first = self.data[self.names[0]]
        return jnp.full(first.shape[:-1], float(self.timestep), dtype=first.dtype)

    def get_times(self) -> jnp.ndarray:
        """Knot times t_k = Σ_{j<k} Δt_j, shape (N,)."""
        dts = self.timesteps()
        return jnp.concatenate(
            [jnp.zeros_like(dts[..., :1]), jnp.cumsum(dts[..., :-1], axis=-1)], axis=-1
        )

    def get_duration(self) -> jnp.ndarray:
        return jnp.sum(self.timesteps()[..., :-1], axis=-1)

    # ------------------------------------------------------------------ #
    # Component editing (add_component / remove_components analogs)
    # ------------------------------------------------------------------ #

    def add_component(
        self,
        name: str,
        values: jax.Array,
        *,
        bounds: object | None = None,
        control: bool = False,
    ) -> "Trajectory":
        if name in self.names or name in self.global_names:
            raise ValueError(f"component {name!r} already exists")
        arr = _as_component_array(values, self.N)
        data = dict(self.data)
        data[name] = arr
        new_bounds = dict(self.bounds)
        if bounds is not None:
            new_bounds[name] = _normalize_bound(bounds, arr.shape[-1])
        return self.replace(
            data=data,
            names=self.names + (name,),
            bounds=new_bounds,
            controls=self.controls + ((name,) if control else ()),
        )

    def remove_components(self, names: Sequence[str]) -> "Trajectory":
        drop = set(names)
        if isinstance(self.timestep, str) and self.timestep in drop:
            raise ValueError("cannot remove the timestep component")
        data = {k: v for k, v in self.data.items() if k not in drop}
        return self.replace(
            data=data,
            names=tuple(n for n in self.names if n not in drop),
            bounds={k: v for k, v in self.bounds.items() if k not in drop},
            initial={k: v for k, v in self.initial.items() if k not in drop},
            final={k: v for k, v in self.final.items() if k not in drop},
            goal={k: v for k, v in self.goal.items() if k not in drop},
            controls=tuple(c for c in self.controls if c not in drop),
        )

    def update(self, **components: jax.Array) -> "Trajectory":
        """Return a copy with some component arrays replaced."""
        data = dict(self.data)
        gdata = dict(self.global_data)
        for k, v in components.items():
            if k in data:
                data[k] = _as_component_array(v, self.N)
            elif k in gdata:
                gdata[k] = jnp.asarray(v, dtype=float).reshape(-1)
            else:
                raise ValueError(f"unknown component {k!r}")
        return self.replace(data=data, global_data=gdata)

    def __getitem__(self, name: str) -> jax.Array:
        if name in self.data:
            return self.data[name]
        return self.global_data[name]
