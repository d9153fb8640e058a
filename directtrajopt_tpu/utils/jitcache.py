"""Shared-trace cache for the Riccati sweep entry points.

The IPM program hits the factor/resolve sweeps (``ops/riccati_kernel.py``)
from several call sites (KKT factor, SOC/restoration resolves, one per
traced phase body); each would otherwise re-trace the same scan.

``jit_cached(fn, *static)`` returns ``jax.jit(partial(fn, *static))`` from a
process-level cache: every same-(statics, shapes, dtypes) call site then
shares ONE traced jaxpr (pjit's own C++ cache does the per-shape keying),
and the outer trace embeds a cheap closed call instead of re-running the
sweep's Python. XLA inlines the nested pjit, so the compiled program is
unchanged — only trace time drops.
"""

import functools

import jax

__all__ = ["jit_cached"]


@functools.lru_cache(maxsize=None)
def jit_cached(fn, *static_args, **static_kwargs):
    """A cached ``jax.jit(functools.partial(fn, *static_args, **kw))``.

    ``fn`` must be a module-level function and the statics hashable — the
    (fn, statics) pair is the cache key; array-shape keying is pjit's job.
    """
    return jax.jit(functools.partial(fn, *static_args, **static_kwargs))
