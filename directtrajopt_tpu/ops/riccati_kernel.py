"""Fused Riccati KKT factor+solve: the backward/forward sweeps over knots.

This is the hot loop of the whole framework: the reference spends its solve
time inside Ipopt's LBLᵀ factorization (`/root/reference/src/solvers/
evaluator.jl:389-404`); here the equivalent work is a backward Riccati sweep
plus multi-RHS solves over small (n_s, n_v ≈ 3–20) stage blocks.

``_factor_solve_xla`` is one fused backward ``lax.scan`` over knots
(factorization AND all R right-hand-side backward recursions in the same
scan body) plus one forward scan; ``_resolve_xla`` solves against stored
factors. Both are written for one instance; a batched solve ``vmap``s them.
The entry points share one trace per (structure, shapes) across the IPM's
call sites (``utils/jitcache.py``).

A hand-written Triton kernel for the sweep (one scenario per GPU thread, the
knot loop inside the kernel) matched the scan to ~1e-6 on an H100 but took
minutes to compile per instance, so it was removed; see ROADMAP Design 1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from directtrajopt_tpu.utils.jitcache import jit_cached

__all__ = ["make_factor_solve", "make_resolve"]


def _factor_solve_xla(s0m, Qss, Qsv, Qvv, A, B, qs, qv, b):
    """Fused backward factor + R-RHS solve. Unbatched.

    Shapes: Qss (N,ns,ns), Qsv (N,ns,nv), Qvv (N,nv,nv), A (N,ns,ns),
    B (N,ns,nv) — stage N−1 rows of A/B/b are zero padding. qs (R,N,ns),
    qv (R,N,nv), b (R,N,ns) — b must be pre-masked by the core mask.
    s0m: static (ns,) 0/1 mask of free initial-state coordinates.

    Returns (P, Lv, Kg, Mvs, L0, ok, dzs, dzv, lam) with lam (R, N−1, ns).
    """
    N, ns, _ = Qss.shape
    nv = Qvv.shape[-1]
    R = qs.shape[0]
    dtype = Qss.dtype
    s0m = np.asarray(s0m, dtype=np.float64)
    eye_v = jnp.eye(nv, dtype=dtype)
    eye_s = jnp.eye(ns, dtype=dtype)
    qsT = jnp.moveaxis(qs, 0, 1)  # (N, R, ns)
    qvT = jnp.moveaxis(qv, 0, 1)
    bT = jnp.moveaxis(b, 0, 1)

    def stage(carry, inp):
        P, p, ok = carry  # P = P_{k+1} (ns,ns), p = p_{k+1} (R,ns)
        qss, qsv, qvv, Ab, Bb, qs_k, qv_k, b_k = inp
        PB = P @ Bb
        PA = P @ Ab
        Hvv = qvv + Bb.T @ PB
        Lv = jnp.linalg.cholesky(Hvv)
        okv = jnp.all(jnp.isfinite(Lv))
        Lv = jnp.where(jnp.isfinite(Lv), Lv, eye_v)
        Mvs = qsv.T + Bb.T @ PA
        Kg = -jax.scipy.linalg.cho_solve((Lv, True), Mvs)
        P_new = qss + Ab.T @ PA + Mvs.T @ Kg
        P_new = 0.5 * (P_new + P_new.T)
        # RHS backward recursion, fused with the factor at the same stage
        w = b_k @ P.T + p  # (R, ns)
        mv = qv_k + w @ Bb  # (R, nv)
        kff = -jax.scipy.linalg.cho_solve((Lv, True), mv.T).T
        p_new = qs_k + w @ Ab + kff @ Mvs
        return (P_new, p_new, ok & okv), (P_new, Lv, Kg, Mvs, kff, p_new)

    (P0, p0, ok), (P_all, Lv_all, Kg_all, Mvs_all, kff_all, p_all) = jax.lax.scan(
        stage,
        (jnp.zeros((ns, ns), dtype), jnp.zeros((R, ns), dtype), jnp.asarray(True)),
        (Qss, Qsv, Qvv, A, B, qsT, qvT, bT),
        reverse=True,
    )

    s0 = jnp.asarray(s0m, dtype=dtype)
    P0m = P0 * s0[:, None] * s0[None, :] + jnp.diag(1.0 - s0)
    L0 = jnp.linalg.cholesky(P0m)
    ok = ok & jnp.all(jnp.isfinite(L0))
    L0 = jnp.where(jnp.isfinite(L0), L0, eye_s)
    ds0 = -jax.scipy.linalg.cho_solve((L0, True), (p0 * s0[None]).T).T * s0[None]

    def fwd(s, inp):
        Kg, kff, Ab, Bb, b_k = inp
        v = s @ Kg.T + kff
        s_next = s @ Ab.T + v @ Bb.T + b_k
        return s_next, (s, v)

    _, (s_all, v_all) = jax.lax.scan(fwd, ds0, (Kg_all, kff_all, A, B, bT))
    lam = -(
        jnp.einsum("kij,krj->rki", P_all[1:], s_all[1:])
        + jnp.moveaxis(p_all[1:], 1, 0)
    )  # (R, N-1, ns)
    dzs = jnp.moveaxis(s_all, 0, 1)
    dzv = jnp.moveaxis(v_all, 0, 1)
    return P_all, Lv_all, Kg_all, Mvs_all, L0, ok, dzs, dzv, lam


def _resolve_xla(s0m, P, Lv, Kg, Mvs, L0, A, B, qs, qv, b):
    """Solve with a stored factorization (SOC / extra right-hand sides)."""
    N, ns, _ = P.shape
    R = qs.shape[0]
    dtype = P.dtype
    s0m = np.asarray(s0m, dtype=np.float64)
    qsT = jnp.moveaxis(qs, 0, 1)
    qvT = jnp.moveaxis(qv, 0, 1)
    bT = jnp.moveaxis(b, 0, 1)
    P_next = jnp.concatenate([P[1:], jnp.zeros((1, ns, ns), dtype)], axis=0)

    def bwd(p, inp):
        Pn, Lv_k, Mvs_k, Ab, Bb, qs_k, qv_k, b_k = inp
        w = b_k @ Pn.T + p
        mv = qv_k + w @ Bb
        kff = -jax.scipy.linalg.cho_solve((Lv_k, True), mv.T).T
        p_new = qs_k + w @ Ab + kff @ Mvs_k
        return p_new, (kff, p_new)

    p0, (kff_all, p_all) = jax.lax.scan(
        bwd,
        jnp.zeros((R, ns), dtype),
        (P_next, Lv, Mvs, A, B, qsT, qvT, bT),
        reverse=True,
    )
    s0 = jnp.asarray(s0m, dtype=dtype)
    ds0 = -jax.scipy.linalg.cho_solve((L0, True), (p0 * s0[None]).T).T * s0[None]

    def fwd(s, inp):
        Kg_k, kff, Ab, Bb, b_k = inp
        v = s @ Kg_k.T + kff
        s_next = s @ Ab.T + v @ Bb.T + b_k
        return s_next, (s, v)

    _, (s_all, v_all) = jax.lax.scan(fwd, ds0, (Kg, kff_all, A, B, bT))
    lam = -(
        jnp.einsum("kij,krj->rki", P[1:], s_all[1:])
        + jnp.moveaxis(p_all[1:], 1, 0)
    )
    return jnp.moveaxis(s_all, 0, 1), jnp.moveaxis(v_all, 0, 1), lam


# A log-depth ``lax.associative_scan`` form of the resolve (both
# substitutions are affine recurrences once the factors are fixed) matched
# `_resolve_xla` to 8e-16 at N=51 but ran slower than the sequential sweep
# at stage sizes ≤ 16; restore it from git history (``_resolve_xla_parallel``)
# if long horizons make the sweep's depth the bottleneck.


def make_factor_solve(s0m_key: tuple):
    """Fused factor+solve for a structure; ``s0m_key`` is the tuple of 0/1
    ints masking the free initial-state coordinates (static)."""
    return jit_cached(_factor_solve_xla, s0m_key)


def make_resolve(s0m_key: tuple):
    """Resolve-with-stored-factors for a structure (see make_factor_solve)."""
    return jit_cached(_resolve_xla, s0m_key)
