"""Batched primal-dual interior-point method, on device.

This replaces the reference's Ipopt/MadNLP backends
(`/root/reference/src/solvers/ipopt_solver/solver.jl`,
`ext/MadNLPSolverExt/`): instead of callback-per-derivative into an external
sparse IPM, the entire solver is a JAX program — one ``lax.while_loop`` whose
body evaluates residuals/derivatives through a swappable operator backend,
factorizes the KKT system, and performs an Ipopt-class step (algorithm
follows Wächter & Biegler):

* slack formulation for inequalities, log barrier for box bounds,
* condensed primal-dual KKT behind an operator interface — dense
  augmented-Lagrangian Cholesky (`ops_dense.py`) or block-structured Riccati
  (`ops_riccati.py`),
* inertia control by primal regularization δ_w with a retry loop,
* fraction-to-boundary rule, filter line search (fixed-size filter arrays in
  the loop carry) with second-order correction,
* monotone (Fiacco–McCormick) barrier schedule with κ_ε inner tolerance,
* dual safeguards (κ_Σ clamp), Ipopt-style acceptable-level termination.

Everything is shape-static and dtype-parametric (f64 on CPU, f32 on GPU) and
the whole solve ``vmap``s over a batch of problem instances — heterogeneous
active sets across the batch are handled naturally since every instance runs
the same predicated operations.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .canonical import CanonicalNLP
from .options import IPMOptions

__all__ = ["IPMState", "IPMResult", "WarmStart", "ipm_solve", "TELEMETRY_COLUMNS"]

_BIG = 1e20
_FILTER_SIZE = 64

# filter / line-search constants (Ipopt defaults)
_GAMMA_THETA = 1e-5
_GAMMA_PHI = 1e-8
_S_THETA = 1.1
_S_PHI = 2.3


def _lbfgs_compact(S, Y, count, sigma_clip=(1e-6, 1e6)):
    """Byrd–Nocedal–Schnabel compact L-BFGS factors ``(σ, U, M)`` with
    ``B = σI − Uᵀ M⁻¹ U``, ``U = [σS; Y]`` (2m, z) and
    ``M = [[σSᵀS, L], [Lᵀ, −D]]``, L strictly-lower of SYᵀ, D = diag(SYᵀ) —
    the same compact form MadNLP's CompactLBFGS carries
    (`/root/reference/ext/MadNLPSolverExt/utils.jl:11-110`). Ring slots
    below ``m − count`` are masked out; their U-columns are zero, so padding
    M's diagonal keeps it invertible without changing B. σ = yᵀy/yᵀs of the
    newest pair (standard B₀ scaling). Consumed two ways: materialized
    dense (:func:`_lbfgs_hessian`, dense backend) or as a low-rank
    Sherman–Morrison–Woodbury correction threaded through the Riccati
    backend's multi-RHS resolve (`ops_riccati._RiccatiCtx.set_lbfgs`)."""
    m, z = S.shape
    dtype = S.dtype
    valid = (jnp.arange(m) >= m - count).astype(dtype)
    Sv = S * valid[:, None]
    Yv = Y * valid[:, None]
    sy_last = jnp.dot(S[-1], Y[-1])
    yy_last = jnp.dot(Y[-1], Y[-1])
    sigma = jnp.where(
        count > 0, yy_last / jnp.maximum(sy_last, 1e-30), 1.0
    )
    sigma = jnp.clip(sigma, *sigma_clip).astype(dtype)
    SS = Sv @ Sv.T
    SY = Sv @ Yv.T
    M = jnp.block(
        [
            [sigma * SS, jnp.tril(SY, -1)],
            [jnp.tril(SY, -1).T, -jnp.diag(jnp.diag(SY))],
        ]
    )
    M = M + jnp.diag(jnp.concatenate([1.0 - valid, 1.0 - valid]))
    U = jnp.concatenate([sigma * Sv, Yv], axis=0)  # (2m, z)
    return sigma, U, M


def _lbfgs_hessian(S, Y, count, sigma_clip=(1e-6, 1e6)):
    """Compact L-BFGS Hessian materialized dense (see :func:`_lbfgs_compact`;
    m ≤ ~6, so the build is O(z²m) — below one dense factorization)."""
    sigma, U, M = _lbfgs_compact(S, Y, count, sigma_clip)
    z = S.shape[1]
    return sigma * jnp.eye(z, dtype=S.dtype) - U.T @ jnp.linalg.solve(M, U)


class IPMState(NamedTuple):
    Z: jax.Array
    s: jax.Array  # inequality slacks (n_in,)
    lam: jax.Array  # equality duals (n_eq,)
    nu: jax.Array  # inequality duals (n_in,)
    zL: jax.Array  # lower-bound duals (z_dim,)
    zU: jax.Array  # upper-bound duals (z_dim,)
    mu: jax.Array  # barrier parameter
    theta_max: jax.Array  # hard cap on constraint violation
    theta_min: jax.Array  # switching threshold
    filter_th: jax.Array  # (F,) filter θ entries (+inf = empty)
    filter_ph: jax.Array  # (F,) filter φ entries
    filter_n: jax.Array  # number of live entries
    phi_hist: jax.Array  # (ls_memory,) recent φ ring for non-monotone LS
    c_e: jax.Array  # equality residuals at Z (carried from the line search)
    c_i: jax.Array  # inequality residuals at Z
    delta_w_last: jax.Array  # last successful regularization
    stall_count: jax.Array  # consecutive stalled restoration steps
    infeasible: jax.Array  # local-infeasibility certificate fired
    rest_failed: jax.Array  # restoration stalled without a certificate
    diverged: jax.Array  # ‖Z‖∞ or ‖s‖∞ exceeded diverging_iterates_tol
    iter: jax.Array
    converged: jax.Array
    acc_count: jax.Array  # consecutive iterations at acceptable tolerance
    stopped: jax.Array  # user callback requested stop
    err: jax.Array  # overall KKT error at μ=0
    obj: jax.Array
    best_kkt: jax.Array  # lowest μ=0 KKT error seen along the run
    best_kkt_ok: jax.Array  # unscaled Ipopt tolerances held at that iterate
    best_kkt_Z: jax.Array  # the iterate that achieved it
    best_kkt_obj: jax.Array
    best_kkt_warm: "WarmStart"  # its slacks/duals (matched pair for warm starts)
    history_Z: jax.Array  # (K, z_dim) iterate ring buffer (K may be 0)
    hist_n: jax.Array
    history_stats: jax.Array  # (T, 8) per-iteration telemetry ring (T may be 0)
    best_score: jax.Array
    best_Z: jax.Array
    # L-BFGS mode only (None otherwise): curvature-pair ring buffers
    # (newest pair in the last slot), live-pair count, and the previous
    # iterate/Lagrangian-gradient needed to complete the next pair
    lbfgs_S: jax.Array | None = None
    lbfgs_Y: jax.Array | None = None
    lbfgs_n: jax.Array | None = None
    lbfgs_g_prev: jax.Array | None = None
    lbfgs_Z_prev: jax.Array | None = None
    # previous iterate's objective (acceptable_obj_change_tol test)
    obj_prev: jax.Array | None = None
    # top-K best-score retention (callbacks.score_top_k > 1 only)
    topk_scores: jax.Array | None = None
    topk_Z: jax.Array | None = None
    # oscillation watchdog (options.osc_watchdog_iter): consecutive
    # tiny-accepted-step count and the monotone proximal-floor boost it
    # ratchets (always arrays in a live solve; None never reaches the loop)
    osc_count: jax.Array | None = None
    delta_w_boost: jax.Array | None = None


class WarmStart(NamedTuple):
    """Slacks and duals carried from a previous solve of the same problem
    structure (the primal travels in the trajectory itself). Used by
    :func:`directtrajopt_tpu.solvers.solve.solve_polished` to hand the f32
    phase's multipliers to the f64 polish — restarting duals from the barrier
    initialization throws away exactly the information a warm start needs."""

    s: jax.Array
    lam: jax.Array
    nu: jax.Array
    zL: jax.Array
    zU: jax.Array


class IPMResult(NamedTuple):
    Z: jax.Array
    state: IPMState
    iterations: jax.Array
    converged: jax.Array
    status: jax.Array  # 0=optimal, 1=acceptable, 2=iteration limit,
    # 3=callback stop, 4=locally infeasible, 5=restoration failed,
    # 6=diverging iterates
    kkt_error: jax.Array
    objective: jax.Array
    history_Z: jax.Array
    best_Z: jax.Array
    best_score: jax.Array
    history_stats: jax.Array  # (T, 8) telemetry ring, columns TELEMETRY_COLUMNS
    # top-K best-score retention (None unless callbacks.score_top_k > 1)
    topk_scores: jax.Array | None = None
    topk_Z: jax.Array | None = None


# column layout of IPMResult.history_stats (the on-device analog of the
# reference's `update_optimizer_state_history`,
# `/root/reference/src/solvers/ipopt_solver/callbacks.jl:221-361`): one row
# per iteration (ring of size IPMCallbacks.telemetry_size), written *before*
# the step so row i describes iterate i.
TELEMETRY_COLUMNS = (
    "objective",
    "inf_pr",
    "inf_du",
    "mu",
    "kkt_error",
    "alpha",
    "delta_w",
    "theta",
)


def _masked_min(x, mask, initial):
    return jnp.min(jnp.where(mask, x, initial), initial=initial)


# ---- error-free transforms (options.compensated_residuals) ---------------- #
# XLA does not reassociate floating-point arithmetic by default, so these
# classic identities hold exactly on device.


def _two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly, s = fl(a+b)."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _csum(terms):
    """Compensated (cascaded two-sum) summation of a list of arrays."""
    s, e = terms[0], None
    for t in terms[1:]:
        s, err = _two_sum(s, t)
        e = err if e is None else e + err
    return s if e is None else s + e


def _two_prod_f32(a, b):
    """Dekker two-prod via Veltkamp split (f32: split at 2^12+1):
    p + e == a·b exactly, p = fl(a·b)."""
    SPLIT = 4097.0  # 2**12 + 1 for float32's 24-bit significand
    ca = a * SPLIT
    ah = ca - (ca - a)
    al = a - ah
    cb = b * SPLIT
    bh = cb - (cb - b)
    bl = b - bh
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ipm_solve(
    nlp: CanonicalNLP,
    Z0: jax.Array,
    options: IPMOptions,
    ops=None,
    callbacks=None,
    warm: "WarmStart | None" = None,
) -> IPMResult:
    """Run the interior-point method from ``Z0`` (one instance; vmap outside).

    ``callbacks``: an optional :class:`IPMCallbacks` with host monitoring,
    device stop conditions, iterate history, and best-snapshot tracking.
    ``warm``: optional :class:`WarmStart` carrying slacks and duals from a
    previous solve (e.g. the f32 phase of :func:`solve_polished`) — without
    it duals restart from the barrier initialization and the first iterations
    re-derive them, which from a near-optimal point wanders off before
    reconverging.
    """
    # XLA:GPU may run f32 matmuls in TF32 (~2⁻¹¹ relative error), which
    # poisons the KKT factorization: reduced-precision products cost a
    # 1e-4-grade KKT floor. Every matmul traced under this solver runs at
    # full f32 precision; the stage blocks are far too small for the tensor
    # cores to matter.
    with jax.default_matmul_precision("highest"):
        return _ipm_solve_inner(nlp, Z0, options, ops, callbacks, warm)


def _ipm_solve_inner(nlp, Z0, options, ops, callbacks, warm=None) -> IPMResult:
    cb = callbacks
    if float(options.max_wall_time) > 0.0:
        # options path for the host wall-clock stop: merge a CACHED callback
        # instance (stable static identity, so repeated jitted solves with
        # the same budget share one compiled program)
        from .callbacks import _wall_stop_cached

        cb = _wall_stop_cached(float(options.max_wall_time)).merged_with(cb)
    hist_k = cb.history_size if cb else 0
    tele_k = getattr(cb, "telemetry_size", 0) if cb else 0
    if ops is None:
        from .ops_dense import DenseOps

        ops = DenseOps(nlp)

    dtype = Z0.dtype
    # mixed-precision residual refinement (options.py: refine_residuals):
    # f64 residuals/RHS inside the f32 solver. No-op when already f64.
    hi = bool(options.refine_residuals) and dtype == jnp.float32
    # compensated f32 measurement arithmetic (options.py rationale); the f64
    # refinement path supersedes it when both are requested
    comp = (
        bool(options.compensated_residuals)
        and dtype == jnp.float32
        and not hi
    )
    if hi and not jax.config.jax_enable_x64:
        raise RuntimeError(
            "refine_residuals needs the f64 residual path: enable it with "
            'jax.config.update("jax_enable_x64", True) before tracing'
        )
    f64 = jnp.float64
    opt = options.astype(dtype)
    # barrier floor: max(mu_min, tol/10) — Ipopt's barrier_tol_factor scale
    # with an explicit user floor (options.py: mu_min)
    mu_floor = jnp.maximum(opt.mu_min, opt.tol / 10.0)
    z_dim, n_eq, n_in = nlp.z_dim, nlp.n_eq, nlp.n_in
    lb, ub = nlp.lb.astype(dtype), nlp.ub.astype(dtype)
    free = nlp.free_mask.astype(dtype)
    has_L = jnp.isfinite(lb)
    has_U = jnp.isfinite(ub)
    mask_L = has_L & (free > 0)
    mask_U = has_U & (free > 0)

    def bound_dists(Z):
        dL = jnp.where(has_L, Z - lb, 1.0)
        dU = jnp.where(has_U, ub - Z, 1.0)
        return dL, dU

    # ---------------- initialization (Ipopt §3.6) ------------------------- #
    Z0 = nlp.apply_pins(Z0.astype(dtype))
    gap = jnp.where(has_L & has_U, ub - lb, jnp.inf)
    pl = jnp.minimum(opt.bound_push * jnp.maximum(1.0, jnp.abs(lb)), opt.bound_frac * gap)
    pu = jnp.minimum(opt.bound_push * jnp.maximum(1.0, jnp.abs(ub)), opt.bound_frac * gap)
    Z_init = jnp.where(mask_L, jnp.maximum(Z0, lb + pl), Z0)
    Z_init = jnp.where(mask_U, jnp.minimum(Z_init, ub - pu), Z_init)

    c_i0 = nlp.c_in(Z_init)
    s_init = jnp.maximum(opt.slack_min, -c_i0 + opt.bound_push)
    mu0 = opt.mu_init

    dL0, dU0 = bound_dists(Z_init)
    zL0 = jnp.where(mask_L, mu0 / dL0, 0.0)
    zU0 = jnp.where(mask_U, mu0 / dU0, 0.0)
    nu0 = mu0 / s_init

    if warm is not None:
        # carried-over slacks/duals (clipped into the cone; the κ_Σ clamp
        # re-centers them against μ after the first step)
        s_init = jnp.maximum(warm.s.astype(dtype), opt.slack_min)
        nu0 = jnp.maximum(warm.nu.astype(dtype), opt.slack_min)
        zL0 = jnp.where(mask_L, jnp.maximum(warm.zL.astype(dtype), opt.slack_min), 0.0)
        zU0 = jnp.where(mask_U, jnp.maximum(warm.zU.astype(dtype), opt.slack_min), 0.0)

    c_e0 = nlp.c_eq(Z_init)
    theta_init = jnp.sum(jnp.abs(c_e0)) + jnp.sum(jnp.abs(c_i0 + s_init))

    # least-squares equality-multiplier initialization (Ipopt §3.6 / its
    # constr_mult_init_max guard): one extra KKT solve at the start point
    # gives λ₀ = argmin-ish ‖∇f + Jᵀλ‖, so the first Lagrangian Hessian is
    # built from meaningful curvature instead of λ=0
    gn = options.hessian_approximation == "gauss_newton"
    sw = (
        options.hessian_regularization
        if options.hessian_regularization
        in ("stagewise", "project", "flip", "floor")
        else False
    )
    lbfgs = options.hessian_approximation == "lbfgs"
    m_l = options.limited_memory_max_history if lbfgs else 0
    lam0 = jnp.zeros((n_eq,), dtype=dtype)
    if warm is not None:
        lam0 = warm.lam.astype(dtype)
    elif options.dual_init == "least_squares" and n_eq:
        ctx0 = ops.prepare(
            Z_init, lam0, nu0, cache=(c_e0, c_i0), gauss_newton=gn,
            stagewise=sw, skip_hessian=lbfgs,
        )
        if lbfgs:  # least-squares dual init: B0 = I is the natural metric
            if hasattr(ctx0, "set_lbfgs"):
                ctx0.set_lbfgs(
                    jnp.ones((), dtype=dtype),
                    jnp.zeros((2 * m_l, z_dim), dtype=dtype),
                    jnp.eye(2 * m_l, dtype=dtype),
                )
            else:
                ctx0.set_hessian(jnp.eye(z_dim, dtype=dtype))
        SigL0 = jnp.where(mask_L, zL0 / dL0, 0.0)
        SigU0 = jnp.where(mask_U, zU0 / dU0, 0.0)
        Sig0 = (SigL0 + SigU0) * free
        D0 = nu0 / s_init if n_in else jnp.zeros((0,), dtype=dtype)
        g0 = free * ctx0.grad_f
        _, lam_ls, ok0, _, _ = ctx0.kkt_step(
            Sig0,
            D0,
            g0,
            jnp.zeros_like(ctx0.c_e),
            jnp.zeros((), dtype=dtype),
            opt,
        )
        good = ok0 & (
            jnp.max(jnp.abs(lam_ls), initial=0.0) <= opt.lam_init_max
        )
        lam0 = jnp.where(good, lam_ls, 0.0)

    state0 = IPMState(
        Z=Z_init,
        s=s_init,
        lam=lam0,
        nu=nu0,
        zL=zL0,
        zU=zU0,
        mu=jnp.asarray(mu0, dtype=dtype),
        theta_max=1e4 * jnp.maximum(1.0, theta_init),
        theta_min=1e-4 * jnp.maximum(1.0, theta_init),
        filter_th=jnp.full((_FILTER_SIZE,), jnp.inf, dtype=dtype),
        filter_ph=jnp.full((_FILTER_SIZE,), jnp.inf, dtype=dtype),
        filter_n=jnp.zeros((), dtype=jnp.int32),
        phi_hist=jnp.full((max(options.ls_memory, 1),), -jnp.inf, dtype=dtype),
        delta_w_last=jnp.zeros((), dtype=dtype),
        stall_count=jnp.zeros((), dtype=jnp.int32),
        osc_count=jnp.zeros((), dtype=jnp.int32),
        delta_w_boost=jnp.ones((), dtype=dtype),
        infeasible=jnp.asarray(False),
        rest_failed=jnp.asarray(False),
        diverged=jnp.asarray(False),
        iter=jnp.zeros((), dtype=jnp.int32),
        converged=jnp.asarray(False),
        acc_count=jnp.zeros((), dtype=jnp.int32),
        stopped=jnp.asarray(False),
        err=jnp.asarray(_BIG, dtype=dtype),
        obj=nlp.objective(Z_init),
        best_kkt=jnp.asarray(_BIG, dtype=dtype),
        best_kkt_ok=jnp.asarray(False),
        best_kkt_Z=Z_init,
        best_kkt_obj=nlp.objective(Z_init),
        best_kkt_warm=WarmStart(s=s_init, lam=lam0, nu=nu0, zL=zL0, zU=zU0),
        history_Z=jnp.zeros((hist_k, z_dim), dtype=dtype),
        hist_n=jnp.zeros((), dtype=jnp.int32),
        history_stats=jnp.zeros((tele_k, 8), dtype=dtype),
        best_score=jnp.asarray(-jnp.inf, dtype=dtype),
        best_Z=Z_init,
        c_e=c_e0,
        c_i=c_i0,
        lbfgs_S=jnp.zeros((m_l, z_dim), dtype=dtype) if lbfgs else None,
        lbfgs_Y=jnp.zeros((m_l, z_dim), dtype=dtype) if lbfgs else None,
        lbfgs_n=jnp.zeros((), jnp.int32) if lbfgs else None,
        lbfgs_g_prev=jnp.zeros((z_dim,), dtype=dtype) if lbfgs else None,
        lbfgs_Z_prev=Z_init if lbfgs else None,
        obj_prev=jnp.asarray(jnp.inf, dtype=dtype),
        topk_scores=(
            jnp.full((callbacks.score_top_k,), -jnp.inf, dtype=dtype)
            if callbacks is not None
            and callbacks.score_fn is not None
            and callbacks.score_top_k > 1
            else None
        ),
        topk_Z=(
            jnp.zeros((callbacks.score_top_k, z_dim), dtype=dtype)
            if callbacks is not None
            and callbacks.score_fn is not None
            and callbacks.score_top_k > 1
            else None
        ),
    )

    s_max = jnp.asarray(100.0, dtype=dtype)

    def _bar(Z, s):
        dL, dU = bound_dists(Z)
        return (
            jnp.sum(jnp.where(mask_L, jnp.log(dL), 0.0))
            + jnp.sum(jnp.where(mask_U, jnp.log(dU), 0.0))
            + jnp.sum(jnp.log(s))
        )

    def barrier_phi_from(f, Z, s, mu, c_e, c_i):
        """φ_μ and θ from precomputed objective and constraint residuals."""
        theta = jnp.sum(jnp.abs(c_e)) + jnp.sum(jnp.abs(c_i + s))
        return f - mu * _bar(Z, s), theta

    def body(st: IPMState) -> IPMState:
        Z, s, lam, nu, zL, zU = st.Z, st.s, st.lam, st.nu, st.zL, st.zU
        dL, dU = bound_dists(Z)

        # residuals at Z were computed by the line-search trial that accepted
        # it — carrying them through the loop saves one full c_eq/c_in (and
        # one objective) evaluation per iteration
        ctx = ops.prepare(
            Z, lam, nu, cache=(st.c_e, st.c_i), gauss_newton=gn,
            stagewise=sw, skip_hessian=lbfgs,
        )
        gf, c_e, c_i = ctx.grad_f, ctx.c_e, ctx.c_i

        if lbfgs:
            # complete the (s, y) pair started at the END of the previous
            # iteration: y = ∇L(Z; λ, ν) − ∇L(Z_prev; λ, ν) at the SAME
            # multipliers (carried in lbfgs_g_prev)
            gL_now = ctx.grad_f
            if n_eq:
                gL_now = gL_now + ctx.JeT(lam)
            if n_in:
                gL_now = gL_now + ctx.JiT(nu)
            s_pair = Z - st.lbfgs_Z_prev
            y_pair = gL_now - st.lbfgs_g_prev
            sy = jnp.dot(s_pair, y_pair)
            ss = jnp.dot(s_pair, s_pair)
            yy = jnp.dot(y_pair, y_pair)
            # curvature condition (skip-update safeguard; MadNLP skips too)
            good = (
                (st.iter > 0)
                & (sy > 1e-8 * jnp.sqrt(ss * yy))
                & jnp.isfinite(sy)
                & (ss > 0)
            )
            lbfgs_S = jnp.where(
                good,
                jnp.concatenate([st.lbfgs_S[1:], s_pair[None]]),
                st.lbfgs_S,
            )
            lbfgs_Y = jnp.where(
                good,
                jnp.concatenate([st.lbfgs_Y[1:], y_pair[None]]),
                st.lbfgs_Y,
            )
            lbfgs_n = jnp.minimum(st.lbfgs_n + good, m_l)
            if hasattr(ctx, "set_lbfgs"):
                # Riccati backend: keep B in compact low-rank form — σI in
                # the stage blocks plus an SMW correction applied through
                # the O(N) factorization (no densification)
                ctx.set_lbfgs(*_lbfgs_compact(lbfgs_S, lbfgs_Y, lbfgs_n))
            else:
                ctx.set_hessian(_lbfgs_hessian(lbfgs_S, lbfgs_Y, lbfgs_n))
        else:
            lbfgs_S, lbfgs_Y, lbfgs_n = st.lbfgs_S, st.lbfgs_Y, st.lbfgs_n

        if hi:
            # f64 residual bundle: every quantity below is small near the
            # solution only because O(1) terms cancel — do the cancellation
            # in f64, cast the small result back (relative precision is
            # preserved by the cast; the f32 *evaluation* error was absolute)
            Z64 = Z.astype(f64)
            gf64 = jax.grad(nlp.objective)(Z64)
            c_e64, vjp_e = jax.vjp(nlp.c_eq, Z64)
            c_i64, vjp_i = jax.vjp(nlp.c_in, Z64)
            free64 = free.astype(f64)
            JeTlam64 = (
                free64 * vjp_e(lam.astype(f64))[0]
                if n_eq
                else jnp.zeros_like(Z64)
            )
            gf, c_e, c_i = (
                gf64.astype(dtype),
                c_e64.astype(dtype),
                c_i64.astype(dtype),
            )

        # ---- optimality errors at the current iterate -------------------- #
        if hi:
            JiTnu64 = (
                vjp_i(nu.astype(f64))[0] if n_in else jnp.zeros_like(Z64)
            )
            r_dual = (
                free64
                * (gf64 + JeTlam64 + JiTnu64 - zL.astype(f64) + zU.astype(f64))
            ).astype(dtype)
        elif comp:
            # five O(1) terms cancelling to O(tol): compensated summation
            # removes the rounding of the cancelling additions exactly
            r_dual = free * _csum([gf, ctx.JeT(lam), ctx.JiT(nu), -zL, zU])
        else:
            r_dual = free * (gf + ctx.JeT(lam) + ctx.JiT(nu) - zL + zU)
        z_sum = jnp.sum(jnp.abs(lam)) + jnp.sum(jnp.abs(nu))
        b_sum = jnp.sum(jnp.abs(zL)) + jnp.sum(jnp.abs(zU))
        n_tot = jnp.maximum(1, n_eq + n_in + 2 * z_dim)
        s_d = jnp.maximum(s_max, (z_sum + b_sum) / n_tot) / s_max
        s_c = jnp.maximum(s_max, b_sum / jnp.maximum(1, 2 * z_dim)) / s_max
        inf_du = jnp.max(jnp.abs(r_dual), initial=0.0)
        inf_pr = jnp.maximum(
            jnp.max(jnp.abs(c_e), initial=0.0),
            jnp.max(jnp.abs(c_i + s), initial=0.0),
        )

        if hi:
            # complementarity products in f64 (dL·zL ≈ μ only by cancellation
            # of the f32-absolute rounding in dL when a bound is nearly active)
            dLc = jnp.where(has_L, Z64 - lb.astype(f64), 1.0)
            dUc = jnp.where(has_U, ub.astype(f64) - Z64, 1.0)
            zLc, zUc = zL.astype(f64), zU.astype(f64)
            sc_, nuc = s.astype(f64), nu.astype(f64)
        else:
            dLc, dUc, zLc, zUc, sc_, nuc = dL, dU, zL, zU, s, nu

        def comp_err(mu_val):
            if comp:
                # d·z ≈ μ only by cancellation: exact-product transforms keep
                # the measured complementarity at input-rounding level
                pL, eL = _two_prod_f32(dLc, zLc)
                pU, eU = _two_prod_f32(dUc, zUc)
                ps, es = _two_prod_f32(sc_, nuc)
                comp_L = jnp.where(mask_L, (pL - mu_val) + eL, 0.0)
                comp_U = jnp.where(mask_U, (pU - mu_val) + eU, 0.0)
                comp_s = (ps - mu_val) + es
            else:
                comp_L = jnp.where(mask_L, dLc * zLc - mu_val, 0.0)
                comp_U = jnp.where(mask_U, dUc * zUc - mu_val, 0.0)
                comp_s = sc_ * nuc - mu_val
            return jnp.maximum(
                jnp.maximum(
                    jnp.max(jnp.abs(comp_L), initial=0.0),
                    jnp.max(jnp.abs(comp_U), initial=0.0),
                ),
                jnp.max(jnp.abs(comp_s), initial=0.0),
            ).astype(dtype)

        base_err = jnp.maximum(inf_du / s_d, inf_pr)
        comp0 = comp_err(0.0)
        e_mu = jnp.maximum(base_err, comp_err(st.mu) / s_c)
        e_0 = jnp.maximum(base_err, comp0 / s_c)

        # Ipopt conjunctive success test: scaled overall error ≤ tol AND each
        # unscaled component within its own tolerance (options.py rationale) —
        # the unscaled tests only bite when the s_d/s_c scalings are large
        unscaled_ok = (
            (inf_du <= opt.dual_inf_tol)
            & (inf_pr <= opt.constr_viol_tol)
            & (comp0 <= opt.compl_inf_tol)
        )
        conv_now = (e_0 <= opt.tol) & unscaled_ok
        # full acceptable_* family (Ipopt; reference options.jl:40-47):
        # every component must clear its acceptable threshold to count
        acc_ok = (
            (e_0 <= opt.acceptable_tol)
            & (inf_pr <= opt.acceptable_constr_viol_tol)
            & (inf_du <= opt.acceptable_dual_inf_tol)
            & (comp0 <= opt.acceptable_compl_inf_tol)
            & (
                jnp.abs(st.obj - st.obj_prev)
                <= opt.acceptable_obj_change_tol
                * jnp.maximum(1.0, jnp.abs(st.obj))
            )
        )
        acc_count = jnp.where(acc_ok, st.acc_count + 1, jnp.zeros((), jnp.int32))
        stop_now = conv_now | (acc_count >= options.acceptable_iter)

        # best-iterate retention: on degenerate problems the iterate can slide
        # along a near-flat valley, transiently touching the acceptable band
        # and bouncing away again (filter accepts θ growth while φ creeps
        # down). Keeping the argmin-KKT iterate makes any such dip a usable
        # certificate — the result reports this iterate, not the last one.
        improved = e_0 < st.best_kkt
        best_kkt = jnp.where(improved, e_0, st.best_kkt)
        best_kkt_ok = jnp.where(improved, unscaled_ok, st.best_kkt_ok)
        best_kkt_Z = jnp.where(improved, Z, st.best_kkt_Z)
        best_kkt_obj = jnp.where(improved, st.obj, st.best_kkt_obj)
        best_kkt_warm = jax.tree.map(
            lambda new, old: jnp.where(improved, new, old),
            WarmStart(s=s, lam=lam, nu=nu, zL=zL, zU=zU),
            st.best_kkt_warm,
        )

        # ---- barrier update (+ filter reset, Ipopt A-5.4) ----------------- #
        if options.mu_strategy == "mehrotra":
            # μ is chosen after the affine-scaling probe below; keep the
            # current value for now and reset the filter on large drops later
            mu = st.mu
            mu_update = jnp.asarray(False)
            filter_th, filter_ph, filter_n = st.filter_th, st.filter_ph, st.filter_n
        elif options.mu_strategy == "adaptive":
            # LOQO-style centrality rule: μ = σ·(avg complementarity), with σ
            # driven by how uncentered the complementarity pairs are
            comp_terms = jnp.concatenate(
                [
                    jnp.where(mask_L, dL * zL, jnp.nan),
                    jnp.where(mask_U, dU * zU, jnp.nan),
                    s * nu,
                ]
            )
            m_cnt = jnp.sum(~jnp.isnan(comp_terms))
            avg_c = jnp.nansum(comp_terms) / jnp.maximum(m_cnt, 1)
            min_c = jnp.nanmin(
                jnp.where(jnp.isnan(comp_terms), jnp.inf, comp_terms)
            )
            has_comp = m_cnt > 0
            xi = jnp.where(has_comp, min_c / jnp.maximum(avg_c, 1e-30), 1.0)
            sigma = 0.1 * jnp.minimum(0.05 * (1.0 - xi) / jnp.maximum(xi, 1e-6), 2.0) ** 3
            mu_target = jnp.clip(sigma * avg_c, mu_floor, opt.mu_init)
            mu = jnp.where(has_comp, mu_target, jnp.maximum(mu_floor, 0.2 * st.mu))
            # reset the filter only on large barrier drops
            mu_update = mu <= 0.1 * st.mu
        else:
            # two-regime Fiacco–McCormick: far from the endgame the inner
            # subproblem is solved loosely and μ plunges; once μ nears tol
            # the classic κ_ε/κ_μ take over so strict tolerances still track
            # the central path (options.py: kappa_epsilon_far rationale)
            switch_level = opt.mu_switch_factor * opt.tol
            endgame = st.mu <= switch_level
            k_eps_far = jnp.where(
                opt.kappa_epsilon_far > 0, opt.kappa_epsilon_far, opt.kappa_epsilon
            )
            k_mu_far = jnp.where(
                opt.kappa_mu_far > 0, opt.kappa_mu_far, opt.kappa_mu
            )
            k_eps = jnp.where(endgame, opt.kappa_epsilon, k_eps_far)
            k_mu = jnp.where(endgame, opt.kappa_mu, k_mu_far)
            mu_update = e_mu <= k_eps * st.mu
            mu_raw = jnp.maximum(
                mu_floor,
                jnp.minimum(k_mu * st.mu, st.mu**opt.theta_mu),
            )
            # the far regime may not skip past the endgame boundary: the
            # superlinear μ^θ term would otherwise jump a loosely-centered
            # iterate straight to the μ floor, leaving nothing to recenter at
            mu_raw = jnp.where(endgame, mu_raw, jnp.maximum(mu_raw, switch_level))
            mu = jnp.where(mu_update, mu_raw, st.mu)
        if options.mu_strategy != "mehrotra":
            filter_th = jnp.where(mu_update, jnp.inf, st.filter_th)
            filter_ph = jnp.where(mu_update, jnp.inf, st.filter_ph)
            filter_n = jnp.where(mu_update, 0, st.filter_n)
        # non-monotone memory is only comparable within one barrier value
        phi_hist = jnp.where(mu_update, -jnp.inf, st.phi_hist)

        # ---- condensed system ------------------------------------------- #
        SigL = jnp.where(mask_L, zL / dL, 0.0)
        SigU = jnp.where(mask_U, zU / dU, 0.0)
        Sig = (SigL + SigU) * free
        D = nu / s if n_in else jnp.zeros((0,), dtype=dtype)

        # per-iteration proximal δ_w floor (options.py: delta_w_min
        # rationale); the μ-tied term carries the lane's watchdog boost
        opt_k = opt.replace(
            delta_w_min=jnp.maximum(
                opt.delta_w_min,
                opt.delta_w_mu_scale * mu * st.delta_w_boost,
            )
        )

        def build_g_hat(mu_v):
            """Condensed-KKT right-hand side at barrier value ``mu_v``.

            Under residual refinement the whole expression is evaluated in
            f64 and shifted by the f64 Jᵀλ: the shifted RHS is the barrier
            dual residual (small near the solution by cancellation of O(1)
            terms), so the cast to f32 keeps full relative precision and the
            KKT solve returns the multiplier increment Δλ instead of λ⁺."""
            if hi:
                mu64 = mu_v.astype(f64)
                g = (
                    gf64
                    - jnp.where(mask_L, mu64 / dLc, 0.0)
                    + jnp.where(mask_U, mu64 / dUc, 0.0)
                )
                if n_in:
                    g = g + vjp_i(mu64 / sc_ + (nuc / sc_) * (c_i64 + sc_))[0]
                return (free64 * (g + JeTlam64)).astype(dtype)
            g = gf - jnp.where(mask_L, mu_v / dL, 0.0) + jnp.where(mask_U, mu_v / dU, 0.0)
            if n_in:
                g = g + ctx.JiT(mu_v / s + D * (c_i + s))
            return free * g

        if options.mu_strategy == "mehrotra":
            # ---- affine-scaling probe (Mehrotra): factor once, solve the
            # μ=0 system, measure the complementarity it would reach, and
            # pick μ = σ·(avg comp) with σ = (μ_aff/μ_avg)³ ---------------- #
            g_aff = gf
            if n_in:
                g_aff = g_aff + ctx.JiT(D * (c_i + s))
            g_aff = free * g_aff
            dZ_a, _, ok, delta_fin, resolve = ctx.kkt_step(
                Sig, D, g_aff, -c_e, st.delta_w_last, opt_k
            )
            if n_in:
                ds_a = -(c_i + s) - ctx.Ji(dZ_a)
                dnu_a = -nu - D * ds_a
            else:
                ds_a = jnp.zeros((0,), dtype=dtype)
                dnu_a = jnp.zeros((0,), dtype=dtype)
            dzL_a = jnp.where(mask_L, -zL - SigL * dZ_a, 0.0)
            dzU_a = jnp.where(mask_U, -zU + SigU * dZ_a, 0.0)
            tau_a = jnp.asarray(0.995, dtype=dtype)
            ap = jnp.minimum(
                _masked_min(-tau_a * dL / jnp.minimum(dZ_a, -1e-30), mask_L & (dZ_a < 0), 1.0),
                _masked_min(tau_a * dU / jnp.maximum(dZ_a, 1e-30), mask_U & (dZ_a > 0), 1.0),
            )
            ad = jnp.minimum(
                _masked_min(-tau_a * zL / jnp.minimum(dzL_a, -1e-30), mask_L & (dzL_a < 0), 1.0),
                _masked_min(-tau_a * zU / jnp.minimum(dzU_a, -1e-30), mask_U & (dzU_a < 0), 1.0),
            )
            if n_in:
                ap = jnp.minimum(
                    ap, _masked_min(-tau_a * s / jnp.minimum(ds_a, -1e-30), ds_a < 0, 1.0)
                )
                ad = jnp.minimum(
                    ad, _masked_min(-tau_a * nu / jnp.minimum(dnu_a, -1e-30), dnu_a < 0, 1.0)
                )
            comp_now = (
                jnp.sum(jnp.where(mask_L, dL * zL, 0.0))
                + jnp.sum(jnp.where(mask_U, dU * zU, 0.0))
                + jnp.sum(s * nu)
            )
            comp_aff = (
                jnp.sum(
                    jnp.where(mask_L, (dL + ap * dZ_a) * (zL + ad * dzL_a), 0.0)
                )
                + jnp.sum(
                    jnp.where(mask_U, (dU - ap * dZ_a) * (zU + ad * dzU_a), 0.0)
                )
                + jnp.sum((s + ap * ds_a) * (nu + ad * dnu_a))
            )
            # dtype-explicit count: jnp.where(bool, 1.0, 0.0) with two weak
            # Python floats is f64 under x64 and silently promoted μ (and
            # with it the whole KKT RHS) on the f32 path
            m_cnt = (jnp.sum(mask_L) + jnp.sum(mask_U) + n_in).astype(dtype)
            mu_avg = comp_now / jnp.maximum(m_cnt, 1.0)
            mu_aff = comp_aff / jnp.maximum(m_cnt, 1.0)
            sigma = jnp.clip((mu_aff / jnp.maximum(mu_avg, 1e-30)) ** 3, 1e-4, 10.0)
            mu_new = jnp.clip(sigma * mu_avg, mu_floor, opt.mu_init)
            mu = jnp.where(m_cnt > 0, mu_new, jnp.maximum(mu_floor, 0.2 * mu))
            # filter reset on large barrier drops
            mu_update = mu <= 0.1 * st.mu
            filter_th = jnp.where(mu_update, jnp.inf, filter_th)
            filter_ph = jnp.where(mu_update, jnp.inf, filter_ph)
            filter_n = jnp.where(mu_update, 0, filter_n)
            phi_hist = jnp.where(mu_update, -jnp.inf, phi_hist)

            g_hat = build_g_hat(mu)
            dZ, lam_plus = resolve(-g_hat, -c_e)
        else:
            g_hat = build_g_hat(mu)
            dZ, lam_plus, ok, delta_fin, resolve = ctx.kkt_step(
                Sig, D, g_hat, -c_e, st.delta_w_last, opt_k
            )
        if hi:
            # the RHS shift by Jᵀλ adds (0, −λ) to the exact solution, so the
            # solver's multiplier output is the increment Δλ, not λ⁺
            lam_plus = lam + lam_plus

        # ---- recover eliminated directions ------------------------------- #
        if n_in:
            ds = -(c_i + s) - ctx.Ji(dZ)
            dnu = mu / s - nu - D * ds
        else:
            ds = jnp.zeros((0,), dtype=dtype)
            dnu = jnp.zeros((0,), dtype=dtype)
        dzL = jnp.where(mask_L, mu / dL - zL - SigL * dZ, 0.0)
        dzU = jnp.where(mask_U, mu / dU - zU + SigU * dZ, 0.0)

        # ---- fraction-to-boundary step sizes ----------------------------- #
        tau = jnp.maximum(opt.tau_min, 1.0 - mu)

        def max_primal_step(dZ_, ds_):
            a = jnp.minimum(
                _masked_min(-tau * dL / jnp.minimum(dZ_, -1e-30), mask_L & (dZ_ < 0), 1.0),
                _masked_min(tau * dU / jnp.maximum(dZ_, 1e-30), mask_U & (dZ_ > 0), 1.0),
            )
            if n_in:
                a = jnp.minimum(
                    a, _masked_min(-tau * s / jnp.minimum(ds_, -1e-30), ds_ < 0, 1.0)
                )
            return a

        a_pri = max_primal_step(dZ, ds)
        a_dual = jnp.minimum(
            _masked_min(-tau * zL / jnp.minimum(dzL, -1e-30), mask_L & (dzL < 0), 1.0),
            _masked_min(-tau * zU / jnp.minimum(dzU, -1e-30), mask_U & (dzU < 0), 1.0),
        )
        if n_in:
            a_dual = jnp.minimum(
                a_dual, _masked_min(-tau * nu / jnp.minimum(dnu, -1e-30), dnu < 0, 1.0)
            )

        # ---- filter line search with second-order correction ------------- #
        # st.obj is objective(Z), carried with the residuals
        phi0, theta0 = barrier_phi_from(st.obj, Z, s, mu, c_e, c_i)
        Dphi = (
            jnp.dot(gf, dZ)
            - mu * jnp.sum(jnp.where(mask_L, dZ / dL, 0.0))
            + mu * jnp.sum(jnp.where(mask_U, dZ / dU, 0.0))
            - (mu * jnp.sum(ds / s) if n_in else 0.0)
        )

        # non-monotone reference (Grippo-style): max φ over the recent-iterate
        # window at this μ; ls_memory=1 (default) is the classic monotone
        # Wächter–Biegler test
        if options.ls_memory > 1:
            phi_ref = jnp.maximum(phi0, jnp.max(phi_hist))
        else:
            phi_ref = phi0

        def acceptable(alpha, phi_t, theta_t):
            vs_filter = jnp.all(
                (theta_t <= (1.0 - _GAMMA_THETA) * filter_th)
                | (phi_t <= filter_ph - _GAMMA_PHI * filter_th)
            )
            switch = (Dphi < 0) & (alpha * (-Dphi) ** _S_PHI > theta0**_S_THETA)
            armijo = phi_t <= phi_ref + opt.eta_ls * alpha * Dphi
            sufficient = (theta_t <= (1.0 - _GAMMA_THETA) * theta0) | (
                phi_t <= phi_ref - _GAMMA_PHI * theta0
            )
            accept = jnp.where(switch & (theta0 <= st.theta_min), armijo, sufficient)
            # f-type stays STRICT (vs φ0, not φ_ref): any relaxed acceptance
            # is classified non-f-type and therefore augments the filter,
            # which bounds non-monotone cycling
            f_type = switch & (phi_t <= phi0 + opt.eta_ls * alpha * Dphi)
            # optional relative θ-growth cap (options.py: theta_growth_cap)
            cap = jnp.where(
                opt.theta_growth_cap > 0,
                jnp.maximum(opt.theta_growth_cap * theta0, st.theta_min),
                jnp.asarray(jnp.inf, dtype=dtype),
            )
            accept = (
                accept
                & vs_filter
                & (theta_t <= st.theta_max)
                & (theta_t <= cap)
                & jnp.isfinite(phi_t)
                & jnp.isfinite(theta_t)
            )
            return accept, f_type

        def trial(alpha, dZ_, ds_):
            """One line-search trial; returns only the scalars (φ, θ, f).

            The residual VECTORS are deliberately not returned: materializing
            (n_trials, n_eq) per lane forced the batched trial tensor into a
            relayout. The accepted candidate's residuals are instead
            re-evaluated once at Z_new below (one batched residual pass) —
            identical up to FMA fusion differences (~1 ulp), same tolerance
            note as the Z_new/Zt remark at the carry site."""
            Zt = nlp.apply_pins(Z + alpha * dZ_)
            st_ = s + alpha * ds_
            c_i_t = nlp.c_in(Zt)
            f_t = nlp.objective(Zt)
            # θ via Σ|c_eq| reduced per part — the concatenated residual
            # vector is never built
            theta_t = nlp.c_eq_l1(Zt) + jnp.sum(jnp.abs(c_i_t + st_))
            phi_t = f_t - mu * _bar(Zt, st_)
            return phi_t, theta_t, f_t

        # first trial at the full step; its residuals are shared with the SOC
        Z_full = nlp.apply_pins(Z + a_pri * dZ)
        s_full = s + a_pri * ds
        if hi:
            # near the floor the θ/φ decrease of the accepting (usually full)
            # step is below f32 evaluation noise — judge it on f64 residuals.
            # Backtracking-grid trials stay f32: they matter far from the
            # solution, where f32 is plenty.
            Zf64 = Z_full.astype(f64)
            c_e_full = nlp.c_eq(Zf64).astype(dtype)
            c_i_full = nlp.c_in(Zf64).astype(dtype)
            f_full = nlp.objective(Zf64).astype(dtype)
        else:
            c_e_full = nlp.c_eq(Z_full)
            c_i_full = nlp.c_in(Z_full)
            f_full = nlp.objective(Z_full)
        phi_1, theta_1 = barrier_phi_from(
            f_full, Z_full, s_full, mu, c_e_full, c_i_full
        )
        acc_1, ftype_1 = acceptable(a_pri, phi_1, theta_1)

        # second-order correction (Ipopt §A-5.7) reusing the factorization
        c_soc = a_pri * c_e + c_e_full
        if n_in:
            ci_soc = a_pri * (c_i + s) + c_i_full + s_full
            g_soc = free * ctx.JiT(D * ci_soc)
        else:
            ci_soc = jnp.zeros((0,), dtype=dtype)
            g_soc = jnp.zeros((z_dim,), dtype=dtype)
        n_rest = options.n_rest_trials if (n_eq or n_in) else 0
        soc_on = options.max_soc > 0
        rest_rhs = []
        if soc_on:
            rest_rhs.append((-g_hat - g_soc, -c_soc))
        if n_rest:
            g_rest = (
                free * ctx.JiT(D * (c_i + s))
                if n_in
                else jnp.zeros((z_dim,), dtype=dtype)
            )
            rest_rhs.append((-g_rest, -c_e))
        if len(rest_rhs) == 2:
            # fuse the SOC and restoration solves into ONE multi-RHS pass
            # over the stored factorization (the sweep streams the stage
            # factors once for both right-hand sides)
            rz2 = jnp.stack([rest_rhs[0][0], rest_rhs[1][0]])
            rc2 = jnp.stack([rest_rhs[0][1], rest_rhs[1][1]])
            dZ2, lam2 = resolve.many(rz2, rc2)
            dZ_soc, lam_soc = dZ2[0], lam2[0]
            dZ_r = dZ2[1]
        elif soc_on:
            dZ_soc, lam_soc = resolve(*rest_rhs[0])
        elif n_rest:
            dZ_r, _ = resolve(*rest_rhs[0])
            # max_soc=0: the SOC slot trials the plain direction at α=0
            dZ_soc, lam_soc = dZ, lam_plus
        else:
            dZ_soc, lam_soc = dZ, lam_plus
        if hi and soc_on:
            # g_hat carries the Jᵀλ shift, so the SOC multiplier output is
            # an increment too (the restoration row's multiplier is discarded)
            lam_soc = lam + lam_soc
        ds_soc = -(ci_soc) - ctx.Ji(dZ_soc) if n_in else jnp.zeros((0,), dtype=dtype)
        a_soc = (
            max_primal_step(dZ_soc, ds_soc)
            if soc_on
            else jnp.zeros((), dtype=dtype)
        )

        # restoration direction: pure feasibility step in the Lagrangian
        # metric (min ½dzᵀ(W+Σ)dz s.t. J dz = −c), solved above in the same
        # multi-RHS pass as the SOC. The lockstep-batch analog of Ipopt's
        # restoration phase: instead of a nested feasibility NLP
        # (data-dependent control flow a lockstep batch cannot afford), the
        # deepest line-search grid slots trial this direction with a θ-only
        # acceptance — same trial count, no extra factorization.
        if n_rest:
            ds_r = (
                -(c_i + s) - ctx.Ji(dZ_r) if n_in else jnp.zeros((0,), dtype=dtype)
            )
            a_r = max_primal_step(dZ_r, ds_r)
        else:
            dZ_r, ds_r = dZ, ds
            a_r = jnp.zeros((), dtype=dtype)

        # backtracking as a parallel trial grid: evaluate all candidate step
        # sizes in one batched pass (a sequential while_loop would make every
        # vmapped lane pay for the slowest lane's backtracks). The last
        # n_rest slots trial the restoration direction, and the SOC trial
        # rides the same vmapped batch as its final slot — one fused
        # residual evaluation for the whole line search.
        n_bt = options.max_ls - n_rest
        n_grid = n_bt + n_rest
        alpha_min = a_pri * (0.5**opt.max_ls)
        alphas_main = a_pri * (0.5 ** jnp.arange(1, n_bt + 1, dtype=dtype))
        alphas_rest = a_r * (0.5 ** jnp.arange(0, n_rest, dtype=dtype))
        # slot layout: [backtracking grid | restoration trials | SOC | α_min]
        # — the SOC trial and the α_min fallback ride the same vmapped batch,
        # so every candidate the step selection can pick has its residuals
        # evaluated exactly once (and the winner's are carried forward)
        alphas_all = jnp.concatenate(
            [alphas_main, alphas_rest, a_soc[None], alpha_min[None]]
        )
        is_rest = jnp.concatenate(
            [jnp.zeros((n_bt,), bool), jnp.ones((n_rest,), bool)]
        )
        dir_idx = jnp.concatenate(
            [
                jnp.zeros((n_bt,), jnp.int32),
                jnp.ones((n_rest,), jnp.int32),
                jnp.full((1,), 2, jnp.int32),
                jnp.zeros((1,), jnp.int32),
            ]
        )

        def trial_dir(alpha, di):
            dZ_ = jnp.where(di == 1, dZ_r, jnp.where(di == 2, dZ_soc, dZ))
            ds_ = (
                jnp.where(di == 1, ds_r, jnp.where(di == 2, ds_soc, ds))
                if n_in
                else ds
            )
            return trial(alpha, dZ_, ds_)

        phis_all, thetas_all, fs_all = jax.vmap(trial_dir)(
            alphas_all, dir_idx
        )
        phi_s, theta_s = phis_all[n_grid], thetas_all[n_grid]
        acc_s, ftype_s = acceptable(a_soc, phi_s, theta_s)
        use_soc = (~acc_1) & (theta_1 > theta0) & acc_s
        phis_bt, thetas_bt = phis_all[:n_grid], thetas_all[:n_grid]
        alphas_all = alphas_all[:n_grid]
        accepts_bt = (
            jax.vmap(acceptable)(alphas_all, phis_bt, thetas_bt)[0] & ~is_rest
        )
        bt_ok = jnp.any(accepts_bt)
        first_idx = jnp.argmax(accepts_bt)
        alpha_bt = alphas_all[first_idx]
        theta_bt = thetas_bt[first_idx]

        # θ-only sufficient decrease for restoration trials (Armijo on the
        # feasibility measure, slope scaled by the relative step size)
        rel_a = alphas_all / jnp.maximum(a_r, 1e-30)
        accepts_r = (
            is_rest
            & (thetas_bt <= (1.0 - opt.rest_theta_factor * rel_a) * theta0)
            & jnp.isfinite(thetas_bt)
            & (theta0 > 10.0 * opt.tol)
        )
        rest_ok = jnp.any(accepts_r)
        rest_idx = jnp.argmax(accepts_r)
        alpha_rest = alphas_all[rest_idx]
        theta_rest = thetas_bt[rest_idx]
        use_rest = (~acc_1) & (~use_soc) & (~bt_ok) & rest_ok

        alpha = jnp.where(
            acc_1,
            a_pri,
            jnp.where(
                use_soc,
                a_soc,
                jnp.where(
                    bt_ok, alpha_bt, jnp.where(rest_ok, alpha_rest, alpha_min)
                ),
            ),
        )
        step_dZ = jnp.where(use_soc, dZ_soc, jnp.where(use_rest, dZ_r, dZ))
        step_ds = (
            jnp.where(use_soc, ds_soc, jnp.where(use_rest, ds_r, ds))
            if n_in
            else ds
        )
        # restoration steps leave the equality duals untouched
        step_lam_plus = jnp.where(
            use_rest, lam, jnp.where(use_soc, lam_soc, lam_plus)
        )
        f_type_step = jnp.where(acc_1, ftype_1, jnp.where(use_soc, ftype_s, False))

        # freeze the step entirely once converged (this pass only records it);
        # restoration steps also freeze the bound/inequality duals
        alpha = jnp.where(stop_now, 0.0, alpha)
        a_dual = jnp.where(stop_now | use_rest, 0.0, a_dual)

        # ---- update ------------------------------------------------------- #
        Z_new = nlp.apply_pins(Z + alpha * step_dZ)
        s_new = s + alpha * step_ds
        lam_new = lam + alpha * (step_lam_plus - lam)
        nu_new = nu + a_dual * dnu
        zL_new = zL + a_dual * dzL
        zU_new = zU + a_dual * dzU

        # carry the accepted candidate's residuals/objective into the next
        # iteration (selection mirrors the α / step-direction precedence
        # above; every selectable candidate has a trial slot, incl. α_min at
        # the last one). A frozen lane (stop_now / NaN guard) keeps Z, so it
        # keeps the current residuals. Note: Z_new and the trial's Zt compute
        # Z + α·dZ through possibly different fusions (FMA vs mul+add), so
        # the carry can differ from re-evaluation by ~1 ulp of Z — far below
        # every tolerance that consumes it.
        idx_sel = jnp.where(
            use_soc,
            n_grid,
            jnp.where(bt_ok, first_idx, jnp.where(rest_ok, rest_idx, n_grid + 1)),
        )
        # one residual pass at the selected iterate replaces gathering from a
        # (n_trials, n_eq) trial tensor (see the layout note in trial());
        # frozen/NaN lanes fall back to the old residuals via took_step below
        c_e_eval = nlp.c_eq(Z_new)
        c_i_eval = nlp.c_in(Z_new)
        c_e_sel = jnp.where(acc_1, c_e_full, c_e_eval)
        c_i_sel = jnp.where(acc_1, c_i_full, c_i_eval)
        f_sel = jnp.where(acc_1, f_full, fs_all[idx_sel])

        # NaN guard: a lane whose step went non-finite freezes at its last
        # good iterate (it will terminate at the iteration limit)
        step_ok = (
            jnp.all(jnp.isfinite(Z_new))
            & jnp.all(jnp.isfinite(s_new))
            & jnp.all(jnp.isfinite(lam_new))
        )
        took_step = step_ok & (~stop_now)
        # oscillation watchdog (options.osc_watchdog_iter): a lane that keeps
        # accepting only tiny backtracked steps is grinding in a gauge valley
        # the current proximal floor cannot damp — after osc_watchdog_iter
        # consecutive such iterations, ratchet its μ-tied floor multiplier.
        # Restoration accepts are excluded (α_rest ~ a_r ≪ a_pri is that
        # direction's natural scale, not a grind signal). The counter is
        # signed: small steps count up toward the boost, near-full steps
        # count down toward a decay (÷osc_boost_factor, floor 1) so the
        # boost doesn't persist through later, well-conditioned phases.
        small_step = took_step & (~use_rest) & (
            alpha < opt.osc_small_frac * a_pri
        )
        full_step = took_step & (~use_rest) & (alpha >= 0.9 * a_pri)
        osc_count = jnp.where(
            small_step,
            jnp.maximum(st.osc_count, 0) + 1,
            jnp.where(
                full_step,
                jnp.minimum(st.osc_count, 0) - 1,
                jnp.zeros_like(st.osc_count),
            ),
        )
        watchdog_on = opt.osc_watchdog_iter > 0
        osc_fire = watchdog_on & (osc_count >= opt.osc_watchdog_iter)
        osc_decay = watchdog_on & (osc_count <= -opt.osc_watchdog_iter)
        delta_w_boost = jnp.where(
            osc_fire,
            jnp.minimum(
                st.delta_w_boost * opt.osc_boost_factor, opt.osc_boost_cap
            ),
            jnp.where(
                osc_decay,
                jnp.maximum(st.delta_w_boost / opt.osc_boost_factor, 1.0),
                st.delta_w_boost,
            ),
        )
        osc_count = jnp.where(osc_fire | osc_decay, 0, osc_count)
        c_e_new = jnp.where(took_step, c_e_sel, c_e)
        c_i_new = jnp.where(took_step, c_i_sel, c_i)
        Z_new = jnp.where(step_ok, Z_new, Z)
        s_new = jnp.where(step_ok, s_new, s)
        lam_new = jnp.where(step_ok, lam_new, lam)
        nu_new = jnp.where(step_ok, nu_new, nu)
        zL_new = jnp.where(step_ok, zL_new, zL)
        zU_new = jnp.where(step_ok, zU_new, zU)

        # dual safeguard (Ipopt κ_Σ clamp)
        dLn, dUn = bound_dists(Z_new)
        zL_new = jnp.where(
            mask_L,
            jnp.clip(zL_new, mu / (opt.kappa_sigma * dLn), opt.kappa_sigma * mu / dLn),
            0.0,
        )
        zU_new = jnp.where(
            mask_U,
            jnp.clip(zU_new, mu / (opt.kappa_sigma * dUn), opt.kappa_sigma * mu / dUn),
            0.0,
        )
        if n_in:
            nu_new = jnp.clip(
                nu_new, mu / (opt.kappa_sigma * s_new), opt.kappa_sigma * mu / s_new
            )

        # diverging-iterates exit (Ipopt diverging_iterates_tol, reference
        # options.jl:51): a finite but exploding iterate terminates with a
        # diagnosable status instead of grinding to the iteration limit
        z_max = jnp.maximum(
            jnp.max(jnp.abs(Z_new), initial=0.0),
            jnp.max(jnp.abs(s_new), initial=0.0),
        )
        diverged = st.diverged | (z_max > opt.diverging_iterates_tol)

        # ---- filter augmentation (on non-f-type acceptance); a restoration
        # step instead clears the filter — its entries described a barrier
        # landscape the feasibility move just left ------------------------- #
        # Full line-search collapse (no trial of ANY direction accepted, only
        # the α_min fallback): do NOT augment — adding the current (θ0, φ0)
        # makes every nearby trial filter-dominated, freezing the lane at
        # α_min until a (false) infeasibility certificate fires. This is the
        # filter-IPM analog of Ipopt's "restoration phase called at an almost
        # feasible point" failure; clearing the filter restarts acceptance
        # from the current point (genuine infeasibility is still caught: the
        # stall counter + stationarity certificate below don't use the
        # filter).
        ls_collapse = (~acc_1) & (~use_soc) & (~bt_ok) & (~stop_now)
        collapse_clear = ls_collapse & (~use_rest)
        slot = filter_n % _FILTER_SIZE
        augment = (~f_type_step) & (~stop_now) & (~use_rest) & (~collapse_clear)
        # iota-mask writes, not .at[slot].set: per-lane dynamic slots lower
        # to (B, F) scatters under vmap; the masked where is one fusable
        # elementwise op
        hit = augment & (jnp.arange(_FILTER_SIZE) == slot)
        filter_th = jnp.where(hit, theta0, filter_th)
        filter_ph = jnp.where(hit, phi0, filter_ph)
        filter_n = filter_n + jnp.where(augment, 1, 0)
        clear_f = use_rest | collapse_clear
        filter_th = jnp.where(clear_f, jnp.inf, filter_th)
        filter_ph = jnp.where(clear_f, jnp.inf, filter_ph)
        filter_n = jnp.where(clear_f, 0, filter_n)
        # push this iterate's φ into the non-monotone window (cleared by a
        # restoration step — the feasibility move left the barrier landscape)
        slot_h = st.iter % phi_hist.shape[0]
        hit_h = (~stop_now) & (jnp.arange(phi_hist.shape[0]) == slot_h)
        phi_hist = jnp.where(hit_h, phi0, phi_hist)
        phi_hist = jnp.where(clear_f, -jnp.inf, phi_hist)

        # ---- local-infeasibility certificate ------------------------------ #
        # Fires when (a) restoration itself stalls for `infeasibility_iter`
        # consecutive attempts while θ is persistently large, and (b) the
        # feasibility problem is first-order stationary: the bound-projected
        # gradient of ½‖c‖² is small relative to θ (a coordinate blocked at
        # its bound contributes min(g, dist-to-bound), so bound-trapped
        # infeasibility is certified too). This is the analog of Ipopt's
        # restoration-phase convergence-to-infeasible-point exit.
        if n_eq or n_in:
            g_feas = free * ctx.JeT(c_e)
            if n_in:
                g_feas = g_feas + free * ctx.JiT(c_i + s)
            g_proj = jnp.where(
                (g_feas > 0) & mask_L,
                jnp.minimum(g_feas, dL),
                jnp.where(
                    (g_feas < 0) & mask_U, jnp.maximum(g_feas, -dU), g_feas
                ),
            )
            feas_stationary = jnp.max(jnp.abs(g_proj), initial=0.0) <= (
                opt.inf_du_tol * jnp.maximum(1.0, theta0)
            )
        else:
            feas_stationary = jnp.asarray(False)
        theta_sel = jnp.where(
            acc_1,
            theta_1,
            jnp.where(
                use_soc,
                theta_s,
                jnp.where(
                    bt_ok, theta_bt, jnp.where(rest_ok, theta_rest, theta0)
                ),
            ),
        )
        # a stall is any iteration where the filter search collapsed (all
        # main-direction trials rejected) and neither the restoration trial
        # nor the α_min fallback moved θ meaningfully — including the case
        # where restoration itself was rejected because no θ decrease exists
        stalled = ls_collapse & (theta_sel > opt.rest_stall_kappa * theta0)
        made_progress = theta_sel <= 0.9 * theta0
        stall_count = jnp.where(
            stalled,
            st.stall_count + 1,
            jnp.where(made_progress, 0, st.stall_count),
        )
        theta_big = theta0 > jnp.maximum(opt.constr_viol_tol, 10.0 * opt.tol)
        # near the optimum the feasibility gradient is O(θ)·‖J‖, so the
        # stationarity test is trivially true at any near-feasible point and
        # grinding line searches there would certify a *nearly converged*
        # iterate as infeasible — require genuine KKT distance too
        far_from_opt = e_0 > 1e2 * jnp.maximum(opt.acceptable_tol, opt.tol)
        infeasible = st.infeasible | (
            (stall_count >= options.infeasibility_iter)
            & theta_big
            & feas_stationary
            & far_from_opt
        )
        # restoration persistently stalled without the stationarity
        # certificate (e.g. θ trapped by barrier curvature): give up early
        # with a diagnosable status instead of burning the iteration budget
        rest_failed = st.rest_failed | (
            (stall_count >= 2 * options.infeasibility_iter)
            & theta_big
            & far_from_opt
        )

        if options.print_level >= 5:
            jax.debug.print(
                "it={i} mu={mu:.1e} obj={o:.6f} th={th:.2e} e0={e:.2e} "
                "emu={em:.2e} a={a:.2e} amax={am:.2e} soc={sc} dw={d:.1e} ok={ok}",
                i=st.iter,
                mu=mu,
                o=st.obj,
                th=theta0,
                e=e_0,
                em=e_mu,
                a=alpha,
                am=a_pri,
                sc=use_soc,
                d=delta_fin,
                ok=ok,
            )

        # ---- user callbacks ---------------------------------------------- #
        obj_new = jnp.where(took_step, f_sel, st.obj)
        if cb is not None and cb.host_fn is not None:
            info = {
                "iteration": st.iter,
                "mu": mu,
                "objective": obj_new,
                "kkt_error": e_0,
                "theta": theta0,
            }
            if cb.include_primal:
                info["Z"] = Z_new
            jax.debug.callback(cb.host_fn, info)
        if cb is not None and cb.stop_fn is not None:
            due = (st.iter % cb.stop_every) == 0
            user_stop = due & cb.stop_fn(Z_new, st.iter)
        else:
            user_stop = jnp.asarray(False)
        if cb is not None and cb.host_stop_fn is not None:
            # host-interactive stop (reference AbstractIntermediateCallback,
            # `/root/reference/src/solvers/_solvers.jl:21-59`): unlike
            # ``host_fn`` (jax.debug.callback, fire-and-forget), io_callback
            # RETURNS the host's verdict into the loop, so arbitrary host
            # logic — wall-clock budgets, interactive abort — can halt the
            # solve with progress preserved (the returned iterate is the
            # in-flight one; status 3 "stopped by callback"). Off the hot
            # path: polled every ``host_stop_every`` iterations via lax.cond
            # (a host round trip per poll, hence the coarse default).
            # The callback fires every iteration (lax.cond around an IO
            # effect does not compose with vmap); ``host_stop_every`` gates
            # the USER function on the host side, so off-cycle iterations
            # cost one cheap round trip and no user code. vmap batches the
            # poll into one host call per lockstep iteration.
            from jax.experimental import io_callback

            h_info = {
                "iteration": st.iter,
                "mu": mu,
                "objective": obj_new,
                "kkt_error": e_0,
                "theta": theta0,
            }
            h_due = (st.iter % cb.host_stop_every) == 0

            def _host_poll(due, info):
                import numpy as _onp

                if not _onp.any(due):
                    return jnp.asarray(False)
                return jnp.asarray(bool(cb.host_stop_fn(info)))

            user_stop = user_stop | io_callback(
                _host_poll,
                jax.ShapeDtypeStruct((), jnp.bool_),
                h_due,
                h_info,
                ordered=False,
            )
        if hist_k:
            history_Z = st.history_Z.at[st.iter % hist_k].set(Z_new)
            hist_n = st.hist_n + 1
        else:
            history_Z, hist_n = st.history_Z, st.hist_n
        if tele_k:
            # one telemetry row per iteration describing the *current* iterate
            # and the step taken from it (columns: TELEMETRY_COLUMNS)
            row = jnp.stack(
                [st.obj, inf_pr, inf_du, mu, e_0, alpha, delta_fin, theta0]
            ).astype(dtype)
            history_stats = st.history_stats.at[st.iter % tele_k].set(row)
        else:
            history_stats = st.history_stats
        if cb is not None and cb.score_fn is not None:
            sc = cb.score_fn(Z_new)
            better = sc > st.best_score
            best_score = jnp.where(better, sc, st.best_score)
            best_Z = jnp.where(better, Z_new, st.best_Z)
            if cb.score_top_k > 1:
                # replace the worst retained snapshot when beaten
                worst = jnp.argmin(st.topk_scores)
                beat = sc > st.topk_scores[worst]
                topk_scores = jnp.where(
                    beat, st.topk_scores.at[worst].set(sc), st.topk_scores
                )
                topk_Z = jnp.where(
                    beat, st.topk_Z.at[worst].set(Z_new), st.topk_Z
                )
            else:
                topk_scores, topk_Z = st.topk_scores, st.topk_Z
        else:
            best_score, best_Z = st.best_score, st.best_Z
            topk_scores, topk_Z = st.topk_scores, st.topk_Z

        return IPMState(
            Z=Z_new,
            s=s_new,
            lam=lam_new,
            nu=nu_new,
            zL=zL_new,
            zU=zU_new,
            mu=mu,
            theta_max=st.theta_max,
            theta_min=st.theta_min,
            filter_th=filter_th,
            filter_ph=filter_ph,
            filter_n=filter_n,
            phi_hist=phi_hist,
            delta_w_last=jnp.where(delta_fin > 0, delta_fin, st.delta_w_last),
            stall_count=stall_count,
            infeasible=infeasible,
            rest_failed=rest_failed,
            diverged=diverged,
            iter=st.iter + jnp.where(stop_now, 0, 1),
            converged=conv_now,
            acc_count=acc_count,
            stopped=st.stopped | user_stop,
            err=e_0,
            obj=obj_new,
            best_kkt=best_kkt,
            best_kkt_ok=best_kkt_ok,
            best_kkt_Z=best_kkt_Z,
            best_kkt_obj=best_kkt_obj,
            best_kkt_warm=best_kkt_warm,
            history_Z=history_Z,
            hist_n=hist_n,
            history_stats=history_stats,
            best_score=best_score,
            best_Z=best_Z,
            c_e=c_e_new,
            c_i=c_i_new,
            lbfgs_S=lbfgs_S,
            lbfgs_Y=lbfgs_Y,
            lbfgs_n=lbfgs_n,
            # start the next pair: ∇L at the CURRENT iterate under the NEW
            # multipliers (this iteration's ctx still holds Z's Jacobians)
            lbfgs_g_prev=(
                ctx.grad_f
                + (ctx.JeT(lam_new) if n_eq else 0.0)
                + (ctx.JiT(nu_new) if n_in else 0.0)
            )
            if lbfgs
            else None,
            lbfgs_Z_prev=Z if lbfgs else None,
            obj_prev=st.obj,
            topk_scores=topk_scores,
            topk_Z=topk_Z,
            osc_count=osc_count,
            delta_w_boost=delta_w_boost,
        )

    def cond(st: IPMState):
        return (
            (~st.converged)
            & (~st.stopped)
            & (~st.infeasible)
            & (~st.rest_failed)
            & (~st.diverged)
            & (st.acc_count < options.acceptable_iter)
            & (st.iter < options.max_iter)
        )

    final = jax.lax.while_loop(cond, body, state0)
    # report the best-KKT iterate (the last body pass records the final Z in
    # the best tracker, so best_kkt ≤ err always). Optimal additionally needs
    # the unscaled Ipopt tolerances to have held at that iterate.
    opt_hit = (final.best_kkt <= opt.tol) & final.best_kkt_ok
    acc_hit = final.best_kkt <= opt.acceptable_tol
    status = jnp.where(
        opt_hit,
        0,
        jnp.where(
            acc_hit,
            1,
            jnp.where(
                final.infeasible,
                4,
                jnp.where(
                    final.rest_failed,
                    5,
                    jnp.where(
                        final.diverged, 6, jnp.where(final.stopped, 3, 2)
                    ),
                ),
            ),
        ),
    )
    return IPMResult(
        Z=final.best_kkt_Z,
        state=final,
        iterations=final.iter,
        converged=opt_hit | acc_hit,
        status=status,
        kkt_error=final.best_kkt,
        objective=final.best_kkt_obj,
        history_Z=final.history_Z,
        best_Z=final.best_Z,
        best_score=final.best_score,
        history_stats=final.history_stats,
        topk_scores=final.topk_scores,
        topk_Z=final.topk_Z,
    )
