"""Tiny pytree-module system.

Every framework object (trajectories, integrators, objectives, constraints,
problems, solver state) is a frozen dataclass registered as a JAX pytree:
array-valued fields are leaves (traceable / vmappable / shardable), while
configuration fields marked with ``static_field()`` live in the treedef and
participate in jit-cache keys.

This is the JAX replacement for the reference's Julia structs + multiple
dispatch (cf. /root/reference/src/common_interface.jl:8-23): instead of
mutating structs through an abstract interface, components are immutable
pytrees consumed by pure functions, so an entire problem — including its
numeric data such as goal states, weights, and dynamics parameters — can be
``jax.vmap``-ed over a scenario batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

T = TypeVar("T")

_STATIC_MARK = "__dtx_static__"


def static_field(**kwargs: Any) -> Any:
    """Declare a dataclass field stored in the pytree treedef (not a leaf).

    Static fields must be hashable (they become part of jit cache keys); use
    tuples instead of lists and ``HashableArray`` for numpy arrays.
    """
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata[_STATIC_MARK] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def field(**kwargs: Any) -> Any:
    """Declare a regular (leaf) dataclass field."""
    return dataclasses.field(**kwargs)


def module(cls: type[T]) -> type[T]:
    """Class decorator: freeze the dataclass and register it as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get(_STATIC_MARK, False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)

    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )

    def _replace(self: T, **changes: Any) -> T:
        return dataclasses.replace(self, **changes)

    cls.replace = _replace  # type: ignore[attr-defined]
    return cls


class HashableArray:
    """Immutable hashable wrapper for a numpy array used as static metadata."""

    __slots__ = ("array", "_hash")

    def __init__(self, array):
        import numpy as np

        arr = np.asarray(array)
        arr.setflags(write=False)
        object.__setattr__(self, "array", arr)
        object.__setattr__(self, "_hash", hash((arr.shape, str(arr.dtype), arr.tobytes())))

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other: object) -> bool:
        import numpy as np

        return (
            isinstance(other, HashableArray)
            and self.array.shape == other.array.shape
            and self.array.dtype == other.array.dtype
            and bool(np.all(self.array == other.array))
        )

    def __repr__(self) -> str:
        return f"HashableArray({self.array!r})"
