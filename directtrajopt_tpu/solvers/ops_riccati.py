"""Block-structured Riccati NLP operator backend — the batched performance path.

The reference hands a general sparse NLP to Ipopt's LBLᵀ factorization. Every
problem the reference actually builds, though, is an *explicit optimal-control
problem*: each integrator's residual is ``x_{k+1} − F(z_k)`` (identity
coupling to the next knot), objectives and nonlinear constraints are
knot-separable, and linear constraints are pins or a handful of coupling rows.
This backend exploits that:

* knot variables split into **states** (integrator targets) and **inputs**;
  the condensed KKT system is a time-varying LQR solved by a backward Riccati
  sweep (``lax.scan`` over knots, ``ops/riccati_kernel.py``) — small dense
  blocks that batch over scenarios;
* the per-stage Cholesky of the reduced input Hessian **is** the inertia
  certificate (what Ipopt reads off its LBLᵀ inertia), so nonconvexity is
  handled by the same δ_w retry loop as the dense path — with *no* 1/δc
  augmented-penalty term, which is what makes the factorization exact in
  f32;
* **chain promotion** (FATROP-style constraint-to-go): banded equality
  chains — TimeConsistency ``t_{k+1}=t_k+Δt_k``, (Δt-)all-equal, any static
  row ``β·z_{k+1}[c] + α·z_k = b`` covering every step — are absorbed into
  the core as extra affine "dynamics" rows (normalized by β), so they cost
  nothing beyond a slightly larger stage block;

* genuinely non-banded equality rows (symmetry, duration, nonlinear
  equality constraints, and pins of *state* coordinates at knots
  ≥ 1) are handled as a low-rank **border** via a Schur complement over the
  Riccati-factored core: m_c extra backward/forward sweeps sharing the same
  factorization, then an m_c × m_c dense Cholesky — with promotion, m_c is
  independent of N for the whole structured constraint zoo.

* **global variables** (GlobalObjective / global-coupled or pure-global
  equality constraints / global linear rows) are an **arrowhead** border:
  n_g extra core solves against the Hzg cross-Hessian columns, then a
  symmetric-indefinite 2×2 block Schur solve over (λ_border, δg) whose
  global-block Cholesky is part of the δ_w inertia certificate.

* **border inequalities**: multi-knot linear inequality rows (e.g. a
  duration bound Σdt ≤ T) and global-coupled / pure-global nonlinear
  inequalities join the same Schur border with the exact −1/D_r slack
  diagonal in place of −δ_c, rhs 0, multipliers discarded — eliminating
  λ_b reproduces (K + J_ibᵀ D J_ib)δz = rhs exactly, so no inequality
  structure falls off the O(N) path.

Cost per KKT solve: O(N·(n_s+n_v)³) sequential-in-k, fully parallel over the
scenario batch — versus O((N·d)³) for the dense path. Eligibility is decided
statically (`analyze`); ineligible problems (implicit integrators, windowed
equality constraints without knot/global residual structure) fall back to
the dense backend with a warning.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..integrators.base import stack_hessians_zk, stack_jacobians_zk
from .canonical import CanonicalNLP
from .ops_dense import _reg_retry

__all__ = ["OCPStructure", "analyze", "RiccatiOps"]

# border Schur systems are typically tiny (m_c ≤ ~8 after chain promotion);
# unroll their cholesky/triangular solves into scalar ops, which vmap into
# full-lane elementwise work instead of per-lane library calls
_UNROLL_CHOL = 8


def _chol(M):
    """Cholesky; unrolled Crout for static n ≤ _UNROLL_CHOL."""
    n = M.shape[-1]
    if n == 0 or n > _UNROLL_CHOL:
        return jnp.linalg.cholesky(M)
    L = [[None] * n for _ in range(n)]
    inv = [None] * n
    for i in range(n):
        for j in range(i + 1):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(s)
                inv[i] = 1.0 / L[i][j]
            else:
                L[i][j] = s * inv[j]
    zero = jnp.zeros_like(M[..., 0, 0])
    rows = [
        jnp.stack([L[i][j] if j <= i else zero for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


def _chosolve(L, b):
    """``(L Lᵀ)⁻¹ b`` with ``b`` (..., n) or (..., n, m); unrolled for tiny n."""
    n = L.shape[-1]
    if n == 0 or n > _UNROLL_CHOL:
        return jax.scipy.linalg.cho_solve((L, True), b)
    vec = b.ndim == L.ndim - 1
    rows = [b[..., i] for i in range(n)] if vec else [b[..., i, :] for i in range(n)]
    inv = [1.0 / L[..., i, i] for i in range(n)]
    y = [None] * n
    for i in range(n):
        s = rows[i]
        for k in range(i):
            s = s - (L[..., i, k] * y[k] if vec else L[..., i, k][..., None] * y[k])
        y[i] = s * inv[i] if vec else s * inv[i][..., None]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - (L[..., k, i] * x[k] if vec else L[..., k, i][..., None] * x[k])
        x[i] = s * inv[i] if vec else s * inv[i][..., None]
    return jnp.stack(x, axis=-1 if vec else -2)


def _stage_min_shift(Q, n_iter: int = 12, margin_rel: float = 1e-5):
    """Per-stage Levenberg shift estimate: ``max(0, −λ̂_min(Q_k) + ε_k)``.

    The global δ_w inertia ladder (Ipopt §3.1 and `_reg_retry`) inflates
    EVERY stage when ANY stage carries indefinite constraint curvature —
    on the bilinear family that costs the exact-Hessian mode a 5× iteration
    penalty vs Gauss-Newton (damped steps lose Newton quality everywhere to
    fix one knot's saddle). This estimates each stage's own most-negative
    eigenvalue so the retry can shift each stage individually past it
    (``options.hessian_regularization == "stagewise"``).

    λ_min is ESTIMATED, not certified: shifted power iteration on
    ``cI − Q`` (c = Gershgorin row bound ⇒ the iterated operator is PSD,
    its λ_max is ``c − λ_min(Q)``), `n_iter` tiny batched matvecs, no
    eigendecomposition (batched eigh of tiny blocks is an iterative
    library call per block). Underestimates only shrink the shift; the Riccati sweep's
    Cholesky inertia certificate and the δ_w ladder remain the backstop.

    Returns the per-stage shift (N,) on the leading Q axes.
    """
    d = Q.shape[-1]
    dtype = Q.dtype
    # Gershgorin upper bound on |λ|: max_i Σ_j |Q_ij|  (per stage)
    c = jnp.max(jnp.sum(jnp.abs(Q), axis=-1), axis=-1)
    c = jnp.maximum(c, jnp.asarray(1e-30, dtype))
    # fixed sign-varying start vector: a constant vector can be orthogonal
    # to the extreme eigenvector on structured stages
    v = jnp.asarray(np.sign(np.sin(1.0 + np.arange(d))), dtype)
    v = jnp.broadcast_to(
        v / jnp.sqrt(jnp.asarray(float(d), dtype)), Q.shape[:-2] + (d,)
    )
    for _ in range(n_iter):
        w = c[..., None] * v - jnp.einsum("...ij,...j->...i", Q, v)
        v = w / jnp.maximum(jnp.linalg.norm(w, axis=-1, keepdims=True), 1e-30)
    ray = jnp.einsum("...i,...ij,...j->...", v, Q, v)  # ≈ λ_min(Q_k)
    return jnp.maximum(0.0, -ray + margin_rel * c)


def _stage_project(Q, mode: str, eps_rel: float = 1e-6):
    """Per-stage spectral modification of the full stage blocks (N, d, d).

    Unlike the Levenberg shift (`_stage_min_shift`, which raises EVERY
    eigenvalue of an indefinite stage by −λ_min and thus damps the
    positive-curvature directions too), this eigendecomposes each stage
    block and modifies only the offending eigenvalues:

    * ``"project"`` — λ → max(λ, ε)  (classic PSD convexification,
      Nocedal–Wright §3.4 eigenvalue modification)
    * ``"flip"``    — λ → max(|λ|, ε)  (saddle-free-Newton style: negative
      directions keep their magnitude but point downhill)
    * ``"floor"``   — λ → max(λ, ε) for λ > −ε, unchanged for λ ≤ −ε:
      raise only the NEAR-ZERO eigenvalues (the gauge-valley pathology the
      δ-floor probe cannot see — a +1e-7 eigenvalue passes the Cholesky
      test and the Newton step along it explodes) while leaving clearly
      negative curvature alone for the certified δ_w inertia ladder.
      Measured (r5): this selective clip does NOT retain "project"'s
      gauge-valley win (family med 116 iterations vs project's 22 — the
      win evidently needs the negative-eigenvalue modification too) and
      still regresses the goal fixtures (stuck at 3.2e-3 — their optimum
      carries the near-zero stage eigenvalue the floor perturbs), so it
      stays an experimental mode documented for completeness.

    ε = eps_rel · max_k λ_max(Q_k) keeps the modified block invertible on a
    common scale. Batched eigh on (N, d, d) is slow, so
    this is the opt-in exact-mode quality knob, not the GN throughput path.
    The δ_w inertia ladder remains the certified backstop downstream.
    """
    Qs = 0.5 * (Q + jnp.swapaxes(Q, -1, -2))
    lam, V = jnp.linalg.eigh(Qs)
    eps = eps_rel * jnp.maximum(jnp.max(jnp.abs(lam)), 1e-30)
    if mode == "flip":
        lam_m = jnp.maximum(jnp.abs(lam), eps)
    elif mode == "floor":
        lam_m = jnp.where(lam > -eps, jnp.maximum(lam, eps), lam)
    else:
        lam_m = jnp.maximum(lam, eps)
    return jnp.einsum("...ij,...j,...kj->...ik", V, lam_m, V)


@dataclass
class OCPStructure:
    """Static structure of an explicit OCP (built once at trace time)."""

    N: int
    d: int
    s_idx: np.ndarray  # (n_s,) state component indices within a knot
    v_idx: np.ndarray  # (n_v,) input component indices
    s_pos: list  # per-integrator (offset, r) into the s-order
    free_blk: np.ndarray  # (N, d) 0/1: 0 where pinned
    core_mask: np.ndarray  # (N-1, n_s) 1 for rows kept in the Riccati core
    bp_steps: np.ndarray  # (n_bp,) step index of border-pinned dynamics rows
    bp_rows: np.ndarray  # (n_bp,) s-order row index of those rows
    bp_flat: np.ndarray  # (n_bp,) flat c_eq indices of those rows
    dyn_flat_of_stack: np.ndarray  # (N-1, n_s) flat c_eq index of each core-stack slot
    s0_mask: np.ndarray  # (n_s,) 1 where s_0 is free to optimize
    # chain promotion (FATROP-style in-core elimination of banded equality
    # chains): trailing s-order slots whose "dynamics" rows are linear
    # equality rows β·z_{k+1}[c] + α·z_k = b, normalized by β in the core
    promo_jr: np.ndarray  # (N-1, n_promo, d) normalized Jacobians α/β
    core_beta: np.ndarray  # (N-1, n_s) β per core row (1 for real dynamics)
    lin_border_rows: np.ndarray  # A_eq row indices NOT promoted (stay border)
    n_g: int  # global-variable count (arrowhead border width)
    g_free: np.ndarray  # (n_g,) 1 where the global coordinate is free
    # inequality row → (knot, slot) maps (fast rows; border rows masked out)
    in_knot: np.ndarray  # (n_in,)
    in_slot: np.ndarray  # (n_in,)
    m_in: int
    # linear ineq COO → per-knot block scatter indices (fast rows only)
    lin_in_nnz: tuple  # (knot, slot, col_local) arrays
    # border inequalities (multi-knot/global-coupled rows): flat c_in index
    # of each border row in C-stack order, per-row fast/border mask, and the
    # A_in row indices of the linear border rows
    ib_flat: np.ndarray  # (n_ib,)
    in_fast_mask: np.ndarray  # (n_in,) 1.0 on fast rows
    ib_lin_rows: np.ndarray  # (n_ib_lin,)
    lin_nnz_keep: np.ndarray  # (nnz,) per-COO-entry fast-row mask
    # nonlinear constraint row bookkeeping
    nl_eq_offsets: list  # flat offsets of each nl eq constraint's rows
    nl_in_offsets: list


def _in_con_border(con) -> bool:
    """True when a nonlinear inequality constraint must ride the Schur
    border (global-coupled or pure-global) instead of the per-knot fast
    path."""
    return (not hasattr(con, "knot_residual")) or getattr(
        con, "uses_global", False
    )


def analyze(nlp: CanonicalNLP) -> OCPStructure | None:
    """Check Riccati eligibility and build the static structure."""
    layout = nlp.layout
    N, d = layout.N, layout.dim
    n_g = layout.global_dim
    if not nlp.integrators:
        return None

    s_list, s_pos = [], []
    for integ in nlp.integrators:
        if not getattr(integ, "explicit", False):
            return None
        cs = layout.comp_slice(integ.x_name)
        s_pos.append((len(s_list), cs.stop - cs.start))
        s_list.extend(range(cs.start, cs.stop))
    if len(set(s_list)) != len(s_list):
        return None  # overlapping targets
    # ---- chain promotion (FATROP-style in-core elimination) -------------- #
    # A static linear-equality row β·z_{k+1}[c] + α·z_k = b is shaped exactly
    # like an (affine) dynamics row. When such rows cover every step
    # k = 0..N-2 for one coordinate c — TimeConsistency t_{k+1}=t_k+Δt_k,
    # TimeStepsAllEqual Δt_{k+1}=Δt_k, derivative-style smoothness chains —
    # c is promoted to a state and the rows join the Riccati core
    # (normalized by β), instead of costing one O(N·(n_s+n_v)²) border sweep
    # per row: the m_c border stays O(1) in N for the structured constraint
    # zoo (VERDICT r1 item 6; the analog of FATROP's constraint-to-go).
    taken = set(s_list)
    chains: dict[int, dict] = {}  # coord c -> {step k: (A_eq row, β, α/β)}
    flat_off = 0
    for rows, cols, vals, rhs, n in nlp.eq_entries:
        if isinstance(vals, np.ndarray) and len(cols) and not np.any(cols >= N * d):
            for r in range(n):
                sel = rows == r
                cs, vs = cols[sel], vals[sel]
                if not len(cs):
                    continue
                kt = int(np.max(cs) // d)
                tgt = cs // d == kt
                if kt < 1 or np.sum(tgt) != 1 or not np.all(cs[~tgt] // d == kt - 1):
                    continue
                c = int(cs[tgt][0] % d)
                beta = float(vs[tgt][0])
                if c in taken or beta == 0.0:
                    continue
                jr = np.zeros(d)
                jr[cs[~tgt] % d] = vs[~tgt] / beta
                chains.setdefault(c, {})[kt - 1] = (flat_off + r, beta, jr)
        flat_off += n
    n_lin_rows = flat_off
    promo_cols = sorted(
        c for c, steps in chains.items() if len(steps) == N - 1
    )
    n_promo = len(promo_cols)
    promo_flat = np.zeros((N - 1, n_promo), dtype=np.int64)
    promo_beta = np.ones((N - 1, n_promo))
    promo_jr = np.zeros((N - 1, n_promo, d))
    promoted_rows: set[int] = set()
    for j, c in enumerate(promo_cols):
        taken.add(c)
        for k in range(N - 1):
            fr, beta, jr = chains[c][k]
            promo_flat[k, j] = fr
            promo_beta[k, j] = beta
            promo_jr[k, j] = jr
            promoted_rows.add(fr)
    lin_border_rows = np.asarray(
        [r for r in range(n_lin_rows) if r not in promoted_rows], dtype=np.int64
    )

    s_idx = np.asarray(s_list + promo_cols, dtype=np.int64)
    v_idx = np.asarray([i for i in range(d) if i not in taken], dtype=np.int64)
    n_s = len(s_idx)

    # equality constraints: knot-local (optionally global-coupled) or pure
    # global — both are handled (global coupling goes through the arrowhead
    # border). Inequalities split two ways: knot-local global-free rows go
    # the FAST way (their D-scaled Gram folds into the per-knot Q blocks);
    # everything else — multi-knot linear rows, global-coupled rows,
    # global-coupled or pure-global nonlinear constraints — becomes a
    # **border inequality**: an extra Schur border row whose (2,2) entry is
    # the exact −1/D_r from slack elimination instead of the −δ_c
    # regularization, rhs 0 (the linear term already flows through JiTᵀ into
    # g_hat), multiplier discarded (the IPM recovers dν from D·Ji(dz)).
    for con in nlp.eq_cons:
        if not (hasattr(con, "knot_residual") or hasattr(con, "global_residual")):
            return None
    for con in nlp.in_cons:
        if not (hasattr(con, "knot_residual") or hasattr(con, "global_residual")):
            return None

    # classify linear inequality rows: knot-local global-free → fast path;
    # multi-knot or global-coupled → border
    ib_lin_rows = []
    row_off0 = 0
    for rows, cols, _, _, n in nlp.in_entries:
        knots = cols // d
        for r in range(n):
            sel = rows == r
            cs = cols[sel]
            if len(cs) and (np.any(cs >= N * d) or not np.all(knots[sel] == knots[sel][0])):
                ib_lin_rows.append(row_off0 + r)
        row_off0 += n
    ib_lin_set = set(ib_lin_rows)

    free = np.ones(N * d + n_g)
    free[nlp.fix_idx] = 0.0
    free_blk = free[: N * d].reshape(N, d)
    g_free = free[N * d :].copy()

    # dynamics rows whose target coordinate is pinned go to the border.
    # fix_idx may also contain GLOBAL indices (≥ N·d, e.g. a pinned global
    # variable via GlobalEqualityConstraint) — those are handled by g_free
    # above, not by knot-row pinning
    target_flat = (np.arange(1, N)[:, None] * d) + s_idx[None, :]  # (N-1, n_s)
    pinned = np.zeros(N * d, dtype=bool)
    pinned[nlp.fix_idx[nlp.fix_idx < N * d]] = True
    bp = pinned[target_flat]  # (N-1, n_s) True where border-pinned
    core_mask = (~bp).astype(np.float64)
    bp_steps, bp_rows = np.nonzero(bp)

    # flat c_eq index of each (step, s-order row): per-integrator k-major,
    # then promoted chains (their rows live in the A_eq range of c_eq)
    dyn_flat = np.zeros((N - 1, n_s), dtype=np.int64)
    off = 0
    for (pos, r) in s_pos:
        for k in range(N - 1):
            dyn_flat[k, pos : pos + r] = off + k * r + np.arange(r)
        off += r * (N - 1)
    core_beta = np.ones((N - 1, n_s))
    if n_promo:
        dyn_flat[:, n_s - n_promo :] = nlp.n_dyn + promo_flat
        core_beta[:, n_s - n_promo :] = promo_beta
    bp_flat = dyn_flat[bp_steps, bp_rows]

    s0_mask = free_blk[0, s_idx].copy()

    # inequality row maps (fast rows only; border rows keep dummy 0/0 slots
    # and are masked out of every fast-path gather/scatter by in_fast_mask)
    n_in = nlp.n_in
    in_knot = np.zeros(n_in, dtype=np.int64)
    in_slot = np.zeros(n_in, dtype=np.int64)
    in_fast_mask = np.ones(n_in)
    per_knot_count = np.zeros(N, dtype=np.int64)
    row_off = 0
    lin_nnz_knot, lin_nnz_slot, lin_nnz_col = [], [], []
    lin_nnz_keep = []  # per-COO-entry: True when the entry's row is fast
    lin_row_slot = {}
    for rows, cols, _, _, n in nlp.in_entries:
        for r in range(n):
            if row_off + r in ib_lin_set:
                in_fast_mask[row_off + r] = 0.0
                continue
            sel = rows == r
            kr = int((cols[sel] // d)[0]) if np.any(sel) else 0
            in_knot[row_off + r] = kr
            in_slot[row_off + r] = per_knot_count[kr]
            lin_row_slot[row_off + r] = (kr, per_knot_count[kr])
            per_knot_count[kr] += 1
        for rr, cc in zip(rows, cols):
            if row_off + rr in ib_lin_set:
                lin_nnz_keep.append(False)
                continue
            lin_nnz_keep.append(True)
            kr, sl = lin_row_slot[row_off + rr]
            lin_nnz_knot.append(kr)
            lin_nnz_slot.append(sl)
            lin_nnz_col.append(cc % d)
        row_off += n
    nl_in_offsets = []
    ib_nl_flat = []
    for con in nlp.in_cons:
        nl_in_offsets.append(row_off)  # flat offset within c_in
        gd = con.g_dim
        if _in_con_border(con):
            T = len(np.asarray(con.times)) if hasattr(con, "knot_residual") else 1
            ib_nl_flat.extend(range(row_off, row_off + T * gd))
            in_fast_mask[row_off : row_off + T * gd] = 0.0
            row_off += T * gd
            continue
        times = np.asarray(con.times)
        for t in times:
            for j in range(gd):
                in_knot[row_off] = t
                in_slot[row_off] = per_knot_count[t]
                per_knot_count[t] += 1
                row_off += 1
    m_in = int(per_knot_count.max()) if n_in else 0
    # border-ineq flat c_in indices, in C-stack row order: linear rows first,
    # then nonlinear border constraints in constraint order
    ib_flat = np.asarray(
        ib_lin_rows + ib_nl_flat, dtype=np.int64
    )

    nl_eq_offsets = []
    off = nlp.n_dyn + nlp.n_lin_eq
    for con in nlp.eq_cons:
        nl_eq_offsets.append(off)
        off += con.constraint_dim(layout)

    return OCPStructure(
        N=N,
        d=d,
        s_idx=s_idx,
        v_idx=v_idx,
        s_pos=s_pos,
        free_blk=free_blk,
        core_mask=core_mask,
        bp_steps=bp_steps,
        bp_rows=bp_rows,
        bp_flat=bp_flat,
        dyn_flat_of_stack=dyn_flat,
        s0_mask=s0_mask,
        promo_jr=promo_jr,
        core_beta=core_beta,
        lin_border_rows=lin_border_rows,
        n_g=n_g,
        g_free=g_free,
        in_knot=in_knot,
        in_slot=in_slot,
        m_in=m_in,
        lin_in_nnz=(
            np.asarray(lin_nnz_knot, dtype=np.int64),
            np.asarray(lin_nnz_slot, dtype=np.int64),
            np.asarray(lin_nnz_col, dtype=np.int64),
        ),
        ib_flat=ib_flat,
        in_fast_mask=in_fast_mask,
        ib_lin_rows=np.asarray(ib_lin_rows, dtype=np.int64),
        lin_nnz_keep=np.asarray(lin_nnz_keep, dtype=bool),
        nl_eq_offsets=nl_eq_offsets,
        nl_in_offsets=nl_in_offsets,
    )


class _RiccatiCtx:
    def __init__(self, nlp: CanonicalNLP, S: OCPStructure, Z, lam, nu,
                 cache=None,
                 gauss_newton: bool = False, stagewise: bool = False,
                 skip_hessian: bool = False):
        self.nlp = nlp
        self.S = S
        self.Z = Z
        layout = nlp.layout
        N, d = S.N, S.d
        dtype = Z.dtype
        self.dtype = dtype
        n_g = S.n_g
        zmat = Z[: N * d].reshape(N, d)
        self.zmat = zmat
        gvec = Z[N * d :]
        self.gvec = gvec

        self.grad_f = jax.grad(nlp.objective)(Z)
        if cache is not None:
            # residuals at Z carried over from the line search that accepted
            # it (bit-identical to re-evaluating; saves one full c_eq/c_in
            # evaluation per IPM iteration)
            self.c_e, self.c_i = cache
        else:
            self.c_e = nlp.c_eq(Z)
            self.c_i = nlp.c_in(Z)

        # dynamics Jacobians w.r.t. z_k, stacked in s-order: (N-1, n_s, d);
        # promoted chains contribute their static normalized rows α/β
        jr_parts = []
        for integ in nlp.integrators:
            jr_parts.append(stack_jacobians_zk(integ, layout, zmat))
        if S.promo_jr.shape[1]:
            jr_parts.append(jnp.asarray(S.promo_jr, dtype=dtype))
        self.Jr = jnp.concatenate(jr_parts, axis=1)
        # core-row normalization: original row = β · (core row); the core
        # sees residuals/λ in normalized form, gathers/scatters rescale
        self.core_beta = jnp.asarray(S.core_beta, dtype=dtype)
        self.core_beta_inv = jnp.asarray(1.0 / S.core_beta, dtype=dtype)
        lin_mask = np.zeros(nlp.n_lin_eq)
        lin_mask[S.lin_border_rows] = 1.0
        self._lin_mask = lin_mask

        # nonlinear constraint Jacobian blocks (per con): (T, gd, d) for
        # knot-local cons; pure-global cons get None here (g-Jacobian below)
        def nl_jac(con):
            if not hasattr(con, "knot_residual"):
                return None
            times = jnp.asarray(np.asarray(con.times))
            z_sel = zmat[times]
            idx = jnp.arange(len(con.times))
            return jax.vmap(
                jax.jacfwd(lambda z, i: con.knot_residual(layout, z, gvec, i)),
                in_axes=(0, 0),
            )(z_sel, idx)

        # global-column Jacobian blocks: (T, gd, n_g) for global-coupled
        # knot cons, (gd, n_g) for pure-global cons, else None
        def nl_jac_g(con):
            if not n_g:
                return None
            if hasattr(con, "knot_residual"):
                if not getattr(con, "uses_global", False):
                    return None
                times = jnp.asarray(np.asarray(con.times))
                z_sel = zmat[times]
                idx = jnp.arange(len(con.times))
                return jax.vmap(
                    jax.jacfwd(
                        lambda z, g, i: con.knot_residual(layout, z, g, i),
                        argnums=1,
                    ),
                    in_axes=(0, None, 0),
                )(z_sel, gvec, idx)
            return jax.jacfwd(lambda g: con.global_residual(layout, g))(gvec)

        self.nl_eq_jacs = [nl_jac(c) for c in nlp.eq_cons]
        self.nl_in_jacs = [nl_jac(c) for c in nlp.in_cons]
        self.nl_eq_jacs_g = [nl_jac_g(c) for c in nlp.eq_cons]
        self.nl_in_jacs_g = [nl_jac_g(c) for c in nlp.in_cons]

        # Lagrangian Hessian blocks Q_W (N, d, d): objective + integrators +
        # nonlinear constraints (multipliers from lam / nu)
        obj = nlp.objective_obj
        # skip_hessian (L-BFGS): no AD Hessians — the model is σI plus a
        # low-rank SMW correction installed by set_lbfgs; gauss_newton is
        # treated as True below so every λ/ν-curvature pass is skipped too
        self._lbfgs = None
        if skip_hessian:
            gauss_newton = True
            QW = jnp.zeros((N, d, d), dtype=dtype)
        else:
            QW = jax.vmap(
                jax.hessian(lambda z, k: obj.cost_at_knot(layout, z, gvec, k)),
                in_axes=(0, 0),
            )(zmat, jnp.arange(N))
        # gauss_newton (options.hessian_approximation): drop the λ/ν-weighted
        # constraint-curvature terms. PSD by construction (objective
        # quadratics + Σ), so δ_w almost never fires, and prepare skips every
        # second-order AD pass through the dynamics — see options.py for the
        # measured iteration-count effect.
        off = 0
        for integ, (pos, r) in zip(nlp.integrators, S.s_pos):
            mu = lam[off : off + r * (N - 1)].reshape(N - 1, r)
            if not gauss_newton:
                blocks = stack_hessians_zk(integ, layout, zmat, mu)
                QW = QW.at[: N - 1].add(blocks)
            off += r * (N - 1)

        def add_nl_hess(QW, cons, offsets, mults):
            for con, o in zip(cons, offsets):
                if not hasattr(con, "knot_residual"):
                    continue  # pure-global: its Hessian lives in Hgg below
                times = np.asarray(con.times)
                T, gd = len(times), con.g_dim
                mu = mults[o : o + T * gd].reshape(T, gd)
                idx = jnp.arange(T)

                def lagr(z, i, m):
                    return jnp.dot(m, con.knot_residual(layout, z, gvec, i))

                blocks = jax.vmap(lambda z, i, m: jax.hessian(lagr)(z, i, m))(
                    zmat[jnp.asarray(times)], idx, mu
                )
                QW = QW.at[jnp.asarray(times)].add(blocks)
            return QW

        if not gauss_newton:
            QW = add_nl_hess(QW, nlp.eq_cons, S.nl_eq_offsets, lam)
            QW = add_nl_hess(QW, nlp.in_cons, S.nl_in_offsets, nu)
        self.QW = QW
        # options.hessian_regularization == "stagewise": kkt_step computes a
        # per-stage λ_min shift and engages it inside the retry ladder (only
        # after the δ-floor probe fails), so well-conditioned problems keep
        # the undamped Newton step
        # mode string ("stagewise" | "project" | "flip") or False; keep the
        # string (`x and not gn` would collapse it to a bool)
        self.stagewise = False if gauss_newton else stagewise

        # ---- arrowhead Hessian blocks: ∂²L/∂z∂g and ∂²L/∂g² --------------- #
        if n_g and skip_hessian:
            # L-BFGS: global coordinates get σ on the diagonal in kkt_step;
            # cross curvature lives in the low-rank correction
            self.Hzg = jnp.zeros((N, d, n_g), dtype=dtype)
            self.Hgg = jnp.zeros((n_g, n_g), dtype=dtype)
        elif n_g:
            Hzg = jnp.zeros((N, d, n_g), dtype=dtype)
            Hgg = jnp.zeros((n_g, n_g), dtype=dtype)
            ks = jnp.arange(N)
            if obj.uses_global:

                def _cost(z, g, k):
                    return obj.cost_at_knot(layout, z, g, k)

                Hzg = Hzg + jax.vmap(
                    jax.jacfwd(jax.grad(_cost, argnums=0), argnums=1),
                    in_axes=(0, None, 0),
                )(zmat, gvec, ks)
                Hgg = Hgg + jnp.sum(
                    jax.vmap(jax.hessian(_cost, argnums=1), in_axes=(0, None, 0))(
                        zmat, gvec, ks
                    ),
                    axis=0,
                )
            Hgg = Hgg + jax.hessian(lambda g: obj.cost_global(layout, g))(gvec)
            # constraint Lagrangian cross terms (global-coupled knot cons +
            # pure-global cons), equality (λ-weighted) AND inequality
            # (ν-weighted, border rows) — dropped under Gauss-Newton.
            eq_arrow = [] if gauss_newton else (
                [
                    (con, o, jg, lam)
                    for con, o, jg in zip(
                        nlp.eq_cons, S.nl_eq_offsets, self.nl_eq_jacs_g
                    )
                ]
                + [
                    (con, o, jg, nu)
                    for con, o, jg in zip(
                        nlp.in_cons, S.nl_in_offsets, self.nl_in_jacs_g
                    )
                ]
            )
            for con, o, jg, mults in eq_arrow:
                if jg is None:
                    continue
                if hasattr(con, "knot_residual"):
                    times = np.asarray(con.times)
                    T, gd = len(times), con.g_dim
                    mu = mults[o : o + T * gd].reshape(T, gd)
                    idx = jnp.arange(T)

                    def lagr(z, g, i, m):
                        return jnp.dot(m, con.knot_residual(layout, z, g, i))

                    cross = jax.vmap(
                        lambda z, i, m: jax.jacfwd(
                            jax.grad(lagr, argnums=0), argnums=1
                        )(z, gvec, i, m)
                    )(zmat[jnp.asarray(times)], idx, mu)
                    Hzg = Hzg.at[jnp.asarray(times)].add(cross)
                    Hgg = Hgg + jnp.sum(
                        jax.vmap(
                            lambda z, i, m: jax.hessian(lagr, argnums=1)(
                                z, gvec, i, m
                            )
                        )(zmat[jnp.asarray(times)], idx, mu),
                        axis=0,
                    )
                else:
                    gd = con.g_dim
                    mu_g = mults[o : o + gd]
                    Hgg = Hgg + jax.hessian(
                        lambda g: jnp.dot(mu_g, con.global_residual(layout, g))
                    )(gvec)
            self.Hzg = Hzg
            self.Hgg = Hgg
        else:
            self.Hzg = jnp.zeros((N, d, 0), dtype=dtype)
            self.Hgg = jnp.zeros((0, 0), dtype=dtype)

        # per-knot inequality Jacobian blocks (N, m, d), columns free-masked
        f_blk = jnp.asarray(S.free_blk, dtype=dtype)
        self.f_blk = f_blk
        if nlp.n_in and S.m_in:
            Jin = jnp.zeros((N, S.m_in, d), dtype=dtype)
            kz, sz, cz = S.lin_in_nnz
            if len(kz):
                # values from the canonical COO entries, in order, restricted
                # to fast rows (border-row entries live in Jib below)
                vals = jnp.concatenate([e[2] for e in nlp.in_entries]).astype(dtype)
                vals = vals[jnp.asarray(np.nonzero(S.lin_nnz_keep)[0])]
                Jin = Jin.at[jnp.asarray(kz), jnp.asarray(sz), jnp.asarray(cz)].add(vals)
            row = sum(e[4] for e in nlp.in_entries)
            for con, jac in zip(nlp.in_cons, self.nl_in_jacs):
                if _in_con_border(con):
                    T = len(np.asarray(con.times)) if hasattr(con, "knot_residual") else 1
                    row += T * con.g_dim
                    continue
                times = np.asarray(con.times)
                T, gd = len(times), con.g_dim
                kn = S.in_knot[row : row + T * gd].reshape(T, gd)
                sl = S.in_slot[row : row + T * gd].reshape(T, gd)
                Jin = Jin.at[jnp.asarray(kn), jnp.asarray(sl), :].add(jac)
                row += T * gd
            self.Jin_raw = Jin
            self.Jin = Jin * f_blk[:, None, :]
        else:
            self.Jin = jnp.zeros((N, max(S.m_in, 0), d), dtype=dtype)
            self.Jin_raw = self.Jin

        # ---- border-inequality Jacobians (raw, unmasked) ------------------ #
        # Row order matches S.ib_flat: linear border rows, then nonlinear
        # border constraints in constraint order. Knot part (n_ib, N, d) and
        # global columns (n_ib, n_g).
        n_ib = len(S.ib_flat)
        self.n_ib = n_ib
        if n_ib:
            Jib_z = jnp.zeros((n_ib, N, d), dtype=dtype)
            Jib_g = jnp.zeros((n_ib, n_g), dtype=dtype)
            pos = 0
            n_ibl = len(S.ib_lin_rows)
            if n_ibl:
                A_rows = nlp.A_in.select_rows(S.ib_lin_rows, dtype)
                Jib_z = Jib_z.at[:n_ibl].set(
                    A_rows[:, : N * d].reshape(n_ibl, N, d)
                )
                if n_g:
                    Jib_g = Jib_g.at[:n_ibl].set(A_rows[:, N * d :])
                pos = n_ibl
            for con, jac, jac_g in zip(
                nlp.in_cons, self.nl_in_jacs, self.nl_in_jacs_g
            ):
                if not _in_con_border(con):
                    continue
                gd = con.g_dim
                if hasattr(con, "knot_residual"):
                    times = np.asarray(con.times)
                    T = len(times)
                    rows_ix = jnp.arange(pos, pos + T * gd).reshape(T, gd)
                    Jib_z = Jib_z.at[rows_ix, jnp.asarray(times)[:, None], :].set(jac)
                    if n_g and jac_g is not None:
                        Jib_g = Jib_g.at[pos : pos + T * gd].set(
                            jac_g.reshape(T * gd, n_g)
                        )
                    pos += T * gd
                else:  # pure-global
                    if n_g and jac_g is not None:
                        Jib_g = Jib_g.at[pos : pos + gd].set(jac_g)
                    pos += gd
            self.Jib_z = Jib_z
            self.Jib_g = Jib_g
        else:
            self.Jib_z = jnp.zeros((0, N, d), dtype=dtype)
            self.Jib_g = jnp.zeros((0, n_g), dtype=dtype)
        self.ib_flat_j = jnp.asarray(S.ib_flat)
        self.in_fast_mask_j = jnp.asarray(S.in_fast_mask, dtype=dtype)
        # static one-hot embedding of the state columns (JeT's column write)
        self._Es = jnp.asarray(np.eye(S.d)[np.asarray(S.s_idx)], dtype=dtype)

    # ---------------- matvecs -------------------------------------------- #

    def JeT(self, v):
        nlp, S = self.nlp, self.S
        N, d, n_s = S.N, S.d, len(S.s_idx)
        n_g = S.n_g
        out = jnp.zeros((N, d), dtype=self.dtype)
        out_g = jnp.zeros((n_g,), dtype=self.dtype)
        # dynamics: rows (N-1, n_s) gathered from flat order. Promoted-chain
        # slots hold the NORMALIZED row (original = β·normalized), so the
        # transpose applies Jᵀv = J_normᵀ(β∘v).
        vd = (
            v[jnp.asarray(S.dyn_flat_of_stack.reshape(-1))].reshape(N - 1, n_s)
            * self.core_beta
        )
        out = out.at[: N - 1].add(jnp.einsum("krd,kr->kd", self.Jr, vd))
        # one-hot matmul, not .at[1:, s_idx]: the index-array column write
        # decomposes into one (B, N, d) dynamic-update-slice PER COLUMN under
        # vmap; vd @ E_s is a tiny
        # fusable matmul and the row shift is one static-offset update
        out = out.at[1:].add(vd @ self._Es)
        full = jnp.concatenate([out.reshape(-1), out_g])
        if nlp.n_lin_eq:
            # promoted rows were consumed above — mask them out of A_eqᵀ
            vl = v[nlp.n_dyn : nlp.n_dyn + nlp.n_lin_eq] * jnp.asarray(
                self._lin_mask, dtype=self.dtype
            )
            full = full + nlp.A_eq.rmatvec(vl)
        for con, jac, jac_g, o in zip(
            nlp.eq_cons, self.nl_eq_jacs, self.nl_eq_jacs_g, S.nl_eq_offsets
        ):
            if hasattr(con, "knot_residual"):
                times = np.asarray(con.times)
                T, gd = len(times), con.g_dim
                vr = v[o : o + T * gd].reshape(T, gd)
                contr = jnp.einsum("tgd,tg->td", jac, vr)
                zpart = (
                    full[: N * d].reshape(N, d).at[jnp.asarray(times)].add(contr)
                )
                gpart = full[N * d :]
                if jac_g is not None:
                    gpart = gpart + jnp.einsum("tgn,tg->n", jac_g, vr)
                full = jnp.concatenate([zpart.reshape(-1), gpart])
            else:
                gd = con.g_dim
                full = full.at[N * d :].add(jac_g.T @ v[o : o + gd])
        return full

    def JiT(self, v):
        nlp, S = self.nlp, self.S
        if nlp.n_in == 0:
            return jnp.zeros((nlp.z_dim,), dtype=self.dtype)
        # scatter flat v into (N, m) then apply block transpose (blocks are
        # free-masked; JiT is used in contexts multiplied by free anyway).
        # Border rows are masked out of the fast scatter and applied via
        # their dense Jib rows (knot + global columns).
        if S.m_in:
            vb = jnp.zeros((S.N, S.m_in), dtype=self.dtype)
            vb = vb.at[jnp.asarray(S.in_knot), jnp.asarray(S.in_slot)].add(
                v * self.in_fast_mask_j
            )
            out = jnp.einsum("nmd,nm->nd", self.Jin_raw, vb)
        else:
            out = jnp.zeros((S.N, S.d), dtype=self.dtype)
        out_g = jnp.zeros((S.n_g,), dtype=self.dtype)
        if self.n_ib:
            v_ib = v[self.ib_flat_j]
            out = out + jnp.einsum("jnd,j->nd", self.Jib_z, v_ib)
            out_g = out_g + self.Jib_g.T @ v_ib
        return jnp.concatenate([out.reshape(-1), out_g])

    def Ji(self, v):
        nlp, S = self.nlp, self.S
        if nlp.n_in == 0:
            return jnp.zeros((0,), dtype=self.dtype)
        vfull = v * nlp.free_mask.astype(self.dtype)
        vm = vfull[: S.N * S.d].reshape(S.N, S.d)
        if S.m_in:
            prod = jnp.einsum("nmd,nd->nm", self.Jin, vm)
            out = prod[jnp.asarray(S.in_knot), jnp.asarray(S.in_slot)]
        else:
            out = jnp.zeros((nlp.n_in,), dtype=self.dtype)
        if self.n_ib:
            out = out * self.in_fast_mask_j
            ib_vals = jnp.einsum("jnd,nd->j", self.Jib_z, vm)
            if S.n_g:
                ib_vals = ib_vals + self.Jib_g @ vfull[S.N * S.d :]
            out = out.at[self.ib_flat_j].set(ib_vals)
        return out

    # ---------------- KKT solve ------------------------------------------ #

    def set_lbfgs(self, sigma, U, M):
        """Install the compact L-BFGS model ``B = σI − Uᵀ M⁻¹ U`` (see
        ``ipm._lbfgs_compact``). kkt_step adds σ to the free stage/global
        diagonals and applies the low-rank term as a Sherman–Morrison–
        Woodbury correction through the factored O(N) solve: 2m extra
        right-hand sides through ``resolve.many`` (one fused factor-sweep)
        plus a (2m)×(2m) dense solve — the Riccati-native analog of
        MadNLP's CompactLBFGS, instead of densifying to z×z."""
        free = self.nlp.free_mask.astype(self.dtype)
        self._lbfgs = (sigma, U * free[None, :], M)

    def kkt_step(self, Sig, D, g_hat, rhs_c, delta_last, opt):
        nlp, S = self.nlp, self.S
        N, d = S.N, S.d
        n_s, n_v = len(S.s_idx), len(S.v_idx)
        n_g = S.n_g
        dtype = self.dtype
        f_blk = self.f_blk
        s_ix = jnp.asarray(S.s_idx)
        v_ix = jnp.asarray(S.v_idx)
        ar = jnp.arange(d)

        # ---- condensed per-knot Hessian blocks --------------------------- #
        Q = self.QW
        # pin projection: rows/cols → 0, diag → 1
        Q = Q * f_blk[:, :, None] * f_blk[:, None, :]
        Q = Q.at[:, ar, ar].add(1.0 - f_blk)
        Q = Q.at[:, ar, ar].add(Sig[: N * d].reshape(N, d))
        if self._lbfgs is not None:
            # L-BFGS base model σI on the free stage diagonal (the low-rank
            # −UᵀM⁻¹U part is applied by SMW after the factored solve)
            Q = Q.at[:, ar, ar].add(self._lbfgs[0] * f_blk)

        # ---- arrowhead blocks (masked; δ-independent parts) --------------- #
        if n_g:
            gf = jnp.asarray(S.g_free, dtype=dtype)
            Hzg_m = self.Hzg * f_blk[:, :, None] * gf[None, None, :]
            Hgg_m = (
                self.Hgg * gf[:, None] * gf[None, :]
                + jnp.diag(1.0 - gf)
                + jnp.diag(Sig[N * d :] * gf)
            )
            if self._lbfgs is not None:
                Hgg_m = Hgg_m + jnp.diag(self._lbfgs[0] * gf)
        else:
            gf = None
            Hzg_m = Hgg_m = None
        if nlp.n_in and S.m_in:
            Db = jnp.zeros((N, S.m_in), dtype=dtype)
            Db = Db.at[jnp.asarray(S.in_knot), jnp.asarray(S.in_slot)].add(
                D * self.in_fast_mask_j
            )
            Q = Q + jnp.einsum("nmd,nm,nme->nde", self.Jin, Db, self.Jin)

        # ---- dynamics blocks --------------------------------------------- #
        Jr_m = self.Jr * f_blk[: N - 1, None, :]  # masked columns
        cm = jnp.asarray(S.core_mask, dtype=dtype)  # (N-1, n_s)
        A_full = -Jr_m * cm[:, :, None]  # masked border rows
        Abar = A_full[:, :, S.s_idx]  # (N-1, n_s, n_s)
        Bbar = A_full[:, :, S.v_idx]  # (N-1, n_s, n_v)
        # pad stage N-1 (no dynamics) with zeros for a uniform scan
        Abar_p = jnp.concatenate([Abar, jnp.zeros((1, n_s, n_s), dtype)], axis=0)
        Bbar_p = jnp.concatenate([Bbar, jnp.zeros((1, n_s, n_v), dtype)], axis=0)

        s0m = jnp.asarray(S.s0_mask, dtype=dtype)
        binv = self.core_beta_inv  # (N-1, n_s); rescales gathered residuals

        # ---- border rows -------------------------------------------------- #
        # Row order: [border-pinned dynamics ; linear equalities ; nonlinear
        # equalities (constraint order)]. Each row has a knot-variable part
        # C (m_c, N, d) and — with global variables — a global-column part
        # Cg (m_c, n_g). Knot-local global-free rows additionally get the
        # ρ curvature shift (see below); global-coupled rows get their
        # inertia certificate through the arrowhead Schur block instead.
        n_bp = len(S.bp_steps)
        n_lb = len(S.lin_border_rows)  # A_eq rows not promoted into the core
        n_border = n_bp + n_lb + sum(
            c.constraint_dim(nlp.layout) for c in nlp.eq_cons
        )
        # border rows built from core (normalized) dynamics rows carry a
        # 1/β rescale on their gathered residuals and multipliers
        bp_binv = S.core_beta[S.bp_steps, S.bp_rows] ** -1.0 if n_bp else np.ones(0)
        C_rows = []
        Cg_rows = []
        rhs_cc = []
        # penalized (knot-local, global-free) row bookkeeping
        loc_knots_l, loc_flat_l, loc_scale_l = [], [], []
        loc_vec_parts = []
        loc_mask_parts = []
        if n_bp:
            C_bp = jnp.zeros((n_bp, N, d), dtype=dtype)
            C_bp = C_bp.at[jnp.arange(n_bp), jnp.asarray(S.bp_steps), :].set(
                Jr_m[jnp.asarray(S.bp_steps), jnp.asarray(S.bp_rows), :]
            )
            C_rows.append(C_bp)
            Cg_rows.append(jnp.zeros((n_bp, n_g), dtype=dtype))
            rhs_cc.append(rhs_c[jnp.asarray(S.bp_flat)] * jnp.asarray(bp_binv, dtype))
            loc_knots_l.append(S.bp_steps)
            loc_flat_l.append(S.bp_flat)
            loc_scale_l.append(bp_binv)
            loc_vec_parts.append(C_bp)
            loc_mask_parts.append(np.ones(n_bp))
        if n_lb:
            A_eq_m = nlp.A_eq.select_rows(
                S.lin_border_rows, dtype
            ) * nlp.free_mask[None, :].astype(dtype)
            C_lin = A_eq_m[:, : N * d].reshape(n_lb, N, d)
            C_rows.append(C_lin)
            Cg_rows.append(A_eq_m[:, N * d :])
            rhs_cc.append(rhs_c[nlp.n_dyn + jnp.asarray(S.lin_border_rows)])
            loc_mask_parts.append(np.zeros(n_lb))
        for con, jac, jac_g, o in zip(
            nlp.eq_cons, self.nl_eq_jacs, self.nl_eq_jacs_g, S.nl_eq_offsets
        ):
            if hasattr(con, "knot_residual"):
                times = np.asarray(con.times)
                T, gd = len(times), con.g_dim
                Cc = jnp.zeros((T * gd, N, d), dtype=dtype)
                rows = jnp.arange(T * gd).reshape(T, gd)
                Cc = Cc.at[rows, jnp.asarray(times)[:, None], :].set(
                    jac * f_blk[jnp.asarray(times)][:, None, :]
                )
                C_rows.append(Cc)
                if jac_g is None:
                    Cg_rows.append(jnp.zeros((T * gd, n_g), dtype=dtype))
                    loc_knots_l.append(np.repeat(times, gd))
                    loc_flat_l.append(np.arange(o, o + T * gd))
                    loc_scale_l.append(np.ones(T * gd))
                    loc_vec_parts.append(Cc)
                    loc_mask_parts.append(np.ones(T * gd))
                else:
                    Cg_rows.append(
                        (jac_g * gf[None, None, :]).reshape(T * gd, n_g)
                    )
                    loc_mask_parts.append(np.zeros(T * gd))
                rhs_cc.append(rhs_c[o : o + T * gd])
            else:  # pure-global constraint: zero knot part
                gd = con.g_dim
                C_rows.append(jnp.zeros((gd, N, d), dtype=dtype))
                Cg_rows.append(jac_g * gf[None, :])
                rhs_cc.append(rhs_c[o : o + gd])
                loc_mask_parts.append(np.zeros(gd))
        # ---- border INEQUALITIES (multi-knot linear rows, global-coupled /
        # pure-global nonlinear rows): same Schur border, but the (2,2)
        # diagonal is the EXACT −1/D_r from slack elimination (not the δc
        # regularization), the rhs is 0 (the linear term already reached
        # g_hat via JiT upstream in the IPM), and the multiplier is
        # discarded — the IPM recovers dν from D·Ji(dz). Eliminating λ_b
        # reproduces (K + J_ibᵀ D J_ib) dz = rhs exactly. ---------------- #
        n_ib = self.n_ib
        n_border += n_ib
        if n_ib:
            C_rows.append(self.Jib_z * f_blk[None])
            Cg_rows.append(
                self.Jib_g * gf[None, :]
                if n_g
                else jnp.zeros((n_ib, 0), dtype=dtype)
            )
            rhs_cc.append(jnp.zeros((n_ib,), dtype=dtype))
            loc_mask_parts.append(np.zeros(n_ib))
            e_ib = 1.0 / jnp.maximum(D[self.ib_flat_j], jnp.asarray(1e-30, dtype))
        else:
            e_ib = jnp.zeros((0,), dtype=dtype)
        if n_border:
            C = jnp.concatenate(C_rows, axis=0)  # (m_c, N, d)
            Cg = (
                jnp.concatenate(Cg_rows, axis=0)
                if n_g
                else jnp.zeros((n_border, 0), dtype=dtype)
            )
            rcc = jnp.concatenate(rhs_cc)
        else:
            C = jnp.zeros((0, N, d), dtype=dtype)
            Cg = jnp.zeros((0, n_g), dtype=dtype)
            rcc = jnp.zeros((0,), dtype=dtype)

        # ---- augmented-Lagrangian curvature shift for knot-local,
        # global-free border rows (pins of state coords, nonlinear
        # equalities): adding ρ·cᵀc to the owning knot's Q block (and ρ·Cᵀr
        # to the rhs inside full_solve) leaves the constrained solution
        # invariant but moves the curvature these constraints fix into the
        # core, so the stage-wise Cholesky inertia certificate matches the
        # full KKT inertia ------------------------------------------------- #
        rho = opt.border_penalty
        if loc_knots_l:
            loc_knots = jnp.asarray(np.concatenate(loc_knots_l))
            loc_flat = np.concatenate(loc_flat_l)
            loc_scale = jnp.asarray(np.concatenate(loc_scale_l), dtype=dtype)
            loc_vecs = jnp.concatenate(loc_vec_parts, axis=0)
            lv = loc_vecs[jnp.arange(len(loc_flat)), loc_knots, :]  # (n_loc, d)
            Q = Q.at[loc_knots].add(rho * lv[:, None, :] * lv[:, :, None])
        else:
            loc_knots = None
            loc_flat = np.zeros((0,), dtype=np.int64)
            loc_scale = None
            lv = None
        # which border rows carry the penalty (matching C row order)
        loc_border_mask = jnp.asarray(
            np.concatenate(loc_mask_parts)
            if loc_mask_parts
            else np.zeros((0,)),
            dtype=dtype,
        )

        # hessian_regularization == "stagewise": per-stage λ_min shift on
        # every factorization. NOT gated on the retry ladder: the bilinear
        # family's pathology is nearly-singular-but-POSITIVE curvature — the
        # δ-floor probe certifies fine and a failure-gated shift never
        # engages (measured: gated = 113 med iterations ≈ the 110 baseline,
        # always-on = 54). The converse cost is real too — on problems whose
        # early indefinite stages still carry correct KKT inertia the shift
        # damps productive Newton steps (cartpole 9 → 41 iterations) — which
        # is why this is an opt-in mode, not the default.
        sw_mode = getattr(self, "stagewise", False)
        sw_shift = None
        if sw_mode in ("project", "flip", "floor"):
            # spectral modification of the full stage blocks (δ_w-independent
            # — do it once, outside the retry ladder), BEFORE slicing the
            # (s, v) sub-blocks so the factorization sees the modified Q
            Q = _stage_project(Q, sw_mode)
        elif sw_mode:  # "stagewise" (or legacy True)
            sw_shift = _stage_min_shift(Q)

        # ---- stage blocks (after the curvature shift) --------------------- #
        Qss = Q[:, s_ix[:, None], s_ix[None, :]]
        Qsv = Q[:, s_ix[:, None], v_ix[None, :]]
        Qvv = Q[:, v_ix[:, None], v_ix[None, :]]

        eye_v = jnp.eye(n_v, dtype=dtype)
        eye_s = jnp.eye(n_s, dtype=dtype)
        fS = f_blk[:, s_ix][:, :, None] * eye_s[None]  # (N, n_s, n_s) diag
        fV = f_blk[:, v_ix][:, :, None] * eye_v[None]

        m_c = C.shape[0]
        R_all = m_c + n_g + 1  # border + arrowhead columns + main rhs
        # per-border-row (2,2) diagonal: δc regularization on equality rows,
        # exact 1/D on inequality rows. refine_e keeps the 1/D term in the
        # Newton-refinement residual (it is part of the true system, not a
        # perturbation to iterate away like δc).
        diag_e = jnp.concatenate(
            [jnp.full((m_c - n_ib,), opt.delta_c, dtype=dtype), e_ib]
        )
        refine_e = jnp.concatenate([jnp.zeros((m_c - n_ib,), dtype=dtype), e_ib])

        def _rho_adjust(rhs_z_blk, rhs_c_flat):
            """Augmented-Lagrangian rhs shift matching the ρ·cᵀc in Q."""
            if lv is not None and len(loc_flat):
                r_loc = rhs_c_flat[jnp.asarray(loc_flat)] * loc_scale
                adj = jnp.zeros((N, d), dtype=dtype).at[loc_knots].add(
                    rho * lv * r_loc[:, None]
                )
                rhs_z_blk = rhs_z_blk + adj
            return rhs_z_blk

        def _b_dyn_pad(rhs_c_flat):
            b_dyn = rhs_c_flat[
                jnp.asarray(S.dyn_flat_of_stack.reshape(-1))
            ].reshape(N - 1, n_s) * binv * cm
            return jnp.concatenate([b_dyn, jnp.zeros((1, n_s), dtype)], axis=0)

        # RHS stack: m_c border columns (−C, zero dynamics rhs), n_g
        # arrowhead columns (−Hzg, zero dynamics rhs), then the main system
        # (−(−g_hat + ρ-shift), dynamics rhs). One fused backward/forward
        # sweep solves them all against one factorization.
        rhs_main = _rho_adjust((-g_hat[: N * d]).reshape(N, d), rhs_c)
        rg_main = -g_hat[N * d :]  # (n_g,) global stationarity rhs
        if n_g:
            Hzg_cols = jnp.transpose(Hzg_m, (2, 0, 1))  # (n_g, N, d)
            q_all = jnp.concatenate([-C, -Hzg_cols, -rhs_main[None]], axis=0)
        else:
            q_all = jnp.concatenate([-C, -rhs_main[None]], axis=0)
        b_all = jnp.concatenate(
            [
                jnp.zeros((m_c + n_g, N, n_s), dtype),
                _b_dyn_pad(rhs_c)[None],
            ],
            axis=0,
        )
        qs_all = q_all[:, :, s_ix]
        qv_all = q_all[:, :, v_ix]

        # ---- fused factorization + multi-RHS solve with δw retry ---------- #
        from ..ops.riccati_kernel import make_factor_solve, make_resolve

        s0_key = tuple(int(v) for v in S.s0_mask)
        FS = make_factor_solve(s0_key)
        RS = make_resolve(s0_key)

        def _scatter_dz(dzs, dzv):
            return (
                jnp.zeros(dzs.shape[:-1] + (d,), dtype)
                .at[..., s_ix]
                .set(dzs)
                .at[..., v_ix]
                .set(dzv)
            )

        def factor(delta_w):
            if sw_shift is not None:
                dshift = delta_w + sw_shift
            else:
                dshift = jnp.broadcast_to(delta_w, (N,))
            P, Lv, Kg, Mvs, L0, okf, dzs, dzv, lamS = FS(
                Qss + dshift[:, None, None] * fS,
                Qsv,
                Qvv + dshift[:, None, None] * fV,
                Abar_p,
                Bbar_p,
                qs_all,
                qv_all,
                b_all,
            )
            if not n_g:
                return (P, Lv, Kg, Mvs, L0, dzs, dzv, lamS, None, None, okf)
            # arrowhead Schur block inside the retry: the δ ladder certifies
            # the reduced global Hessian T = Hgg' − HzgᵀK⁻¹Hzg (+W₁ᵀM⁻¹W₁)
            dz_all_ = _scatter_dz(dzs, dzv)
            Y = dz_all_[m_c : m_c + n_g]
            HzgTY = jnp.einsum("ndg,jnd->gj", Hzg_m, Y)
            Tm = (
                Hgg_m
                + delta_w * jnp.diag(gf)
                - 0.5 * (HzgTY + HzgTY.T)
            )
            if m_c:
                X = dz_all_[:m_c]
                Smat = jnp.einsum("jnd,knd->jk", C, X) + jnp.diag(diag_e)
                Ls_ = _chol(Smat)
                ok_s = jnp.all(jnp.isfinite(Ls_))
                Ls_ = jnp.where(jnp.isfinite(Ls_), Ls_, jnp.eye(m_c, dtype=dtype))
                W1_ = jnp.einsum("jnd,ind->ji", C, Y) - Cg
                Tred = Tm + W1_.T @ _chosolve(Ls_, W1_)
            else:
                Ls_ = None
                W1_ = None
                ok_s = jnp.asarray(True)
                Tred = Tm
            Lg_ = _chol(Tred)
            ok_g = jnp.all(jnp.isfinite(Lg_))
            Lg_ = jnp.where(jnp.isfinite(Lg_), Lg_, jnp.eye(n_g, dtype=dtype))
            return (
                P, Lv, Kg, Mvs, L0, dzs, dzv, lamS,
                (Ls_, W1_) if m_c else None,
                Lg_,
                okf & ok_s & ok_g,
            )

        (
            delta,
            P_all,
            Lv_all,
            Kg_all,
            Mvs_all,
            L0,
            dzs,
            dzv,
            lamS,
            schur_mc,
            Lg,
            ok,
        ) = _reg_retry(factor, delta_last, opt, dtype)

        lamS = lamS * cm[None]
        dz_all = _scatter_dz(dzs, dzv)

        # border columns + Schur factor, shared by main solve and SOC resolve
        if n_g:
            Y, Ylam = dz_all[m_c : m_c + n_g], lamS[m_c : m_c + n_g]
            if m_c:
                Xz, Xlam = dz_all[:m_c], lamS[:m_c]
                Ls, W1 = schur_mc
            else:
                Xz = Xlam = Ls = W1 = None
            ok_s_factor = jnp.asarray(True)  # certified inside the retry
            Hgg_d = Hgg_m + delta * jnp.diag(gf)
        elif m_c:
            Xz, Xlam = dz_all[:m_c], lamS[:m_c]
            Smat = jnp.einsum("jnd,knd->jk", C, Xz) + jnp.diag(diag_e)
            Ls = _chol(Smat)
            ok_s_factor = jnp.all(jnp.isfinite(Ls))
            Ls = jnp.where(jnp.isfinite(Ls), Ls, jnp.eye(m_c, dtype=dtype))
            Y = Ylam = W1 = None
        else:
            Xz = Xlam = Ls = Y = Ylam = W1 = None
            ok_s_factor = jnp.asarray(True)

        def _block_solve(r1, r2):
            """Solve [M W₁; −W₁ᵀ T](λ, dg) = (r1, r2) with stored factors."""
            if n_g:
                if m_c:
                    t = r2 + W1.T @ _chosolve(Ls, r1)
                    dg = _chosolve(Lg, t)
                    lam_c = _chosolve(Ls, r1 - W1 @ dg)
                else:
                    dg = _chosolve(Lg, r2)
                    lam_c = jnp.zeros((0,), dtype)
            else:
                dg = jnp.zeros((0,), dtype)
                lam_c = _chosolve(Ls, r1)
            return lam_c, dg

        def _combine(dz0, lam0, rhs_c_flat, rg):
            """Schur-combine a core solution with border + arrowhead columns.

            Solves the bordered system for (λc, dg) by Newton iteration on
            the factored block solve (3 passes: initial + 2 refinements that
            remove the δc perturbation), then corrects dz and the dynamics
            multipliers."""
            if m_c == 0 and n_g == 0:
                return dz0, lam0, jnp.zeros((0,), dtype), jnp.zeros((0,), dtype), ok_s_factor
            rcc_j = _border_rhs(rhs_c_flat)
            lam_c = jnp.zeros((m_c,), dtype)
            dg = jnp.zeros((n_g,), dtype)
            dz = dz0
            for _ in range(3):
                if m_c:
                    R1 = (
                        jnp.einsum("jnd,nd->j", C, dz)
                        + (Cg @ dg if n_g else 0.0)
                        - (refine_e * lam_c if n_ib else 0.0)
                        - rcc_j
                    )
                else:
                    R1 = jnp.zeros((0,), dtype)
                if n_g:
                    R2 = (
                        jnp.einsum("ndg,nd->g", Hzg_m, dz)
                        + Hgg_d @ dg
                        + (Cg.T @ lam_c if m_c else 0.0)
                        - rg
                    )
                else:
                    R2 = jnp.zeros((0,), dtype)
                dlam, ddg = _block_solve(R1, -R2)
                lam_c = lam_c + dlam
                dg = dg + ddg
                dz = dz0
                if m_c:
                    dz = dz - jnp.einsum("jnd,j->nd", Xz, lam_c)
                if n_g:
                    dz = dz - jnp.einsum("jnd,j->nd", Y, dg)
            lam_stack = lam0
            if m_c:
                lam_stack = lam_stack - jnp.einsum("jkr,j->kr", Xlam, lam_c)
            if n_g:
                lam_stack = lam_stack - jnp.einsum("jkr,j->kr", Ylam, dg)
            # undo the augmented-Lagrangian shift in the border multipliers:
            # the aug system returns λ̃c with C'λ̃c = C'λc − ρC'(C dz − r) on
            # penalized rows, so λc = λ̃c + ρ(C dz − r) there (penalized rows
            # are global-free, so the Cg·dg term vanishes on them)
            if m_c:
                r_b = jnp.einsum("jnd,nd->j", C, dz) - rcc_j
                lam_c = lam_c + rho * loc_border_mask * r_b
            return dz, lam_stack, lam_c, dg, ok_s_factor

        def full_solve_extra(rhs_z_full, rhs_c_flat):
            """Solve core + border for a NEW rhs, reusing the factorization."""
            rhs_z_blk = _rho_adjust(
                rhs_z_full[: N * d].reshape(N, d), rhs_c_flat
            )
            rg = rhs_z_full[N * d :]
            q1 = -rhs_z_blk[None]
            dzs1, dzv1, lam1 = RS(
                P_all,
                Lv_all,
                Kg_all,
                Mvs_all,
                L0,
                Abar_p,
                Bbar_p,
                q1[:, :, s_ix],
                q1[:, :, v_ix],
                _b_dyn_pad(rhs_c_flat)[None],
            )
            lam0 = lam1[0] * cm
            dz0 = (
                jnp.zeros((N, d), dtype)
                .at[:, s_ix]
                .set(dzs1[0])
                .at[:, v_ix]
                .set(dzv1[0])
            )
            return _combine(dz0, lam0, rhs_c_flat, rg)

        def _border_rhs(rhs_c_flat):
            parts = []
            if n_bp:
                parts.append(
                    rhs_c_flat[jnp.asarray(S.bp_flat)] * jnp.asarray(bp_binv, dtype)
                )
            if n_lb:
                parts.append(rhs_c_flat[nlp.n_dyn + jnp.asarray(S.lin_border_rows)])
            for con, o in zip(nlp.eq_cons, S.nl_eq_offsets):
                cd = con.constraint_dim(nlp.layout)
                parts.append(rhs_c_flat[o : o + cd])
            if n_ib:  # border-inequality rows always carry rhs 0
                parts.append(jnp.zeros((n_ib,), dtype=dtype))
            if parts:
                return jnp.concatenate(parts)
            return jnp.zeros((0,), dtype=dtype)

        def pack_lam(lam_stack, lam_c):
            # the core/border solve works on normalized rows (original row =
            # β·normalized), so original multipliers are λ_norm/β
            lam_flat = jnp.zeros((nlp.n_eq,), dtype=dtype)
            lam_flat = lam_flat.at[
                jnp.asarray(S.dyn_flat_of_stack.reshape(-1))
            ].set((lam_stack * binv).reshape(-1))
            pos = 0
            if n_bp:
                lam_flat = lam_flat.at[jnp.asarray(S.bp_flat)].set(
                    lam_c[:n_bp] * jnp.asarray(bp_binv, dtype)
                )
                pos = n_bp
            if n_lb:
                lam_flat = lam_flat.at[
                    nlp.n_dyn + jnp.asarray(S.lin_border_rows)
                ].set(lam_c[pos : pos + n_lb])
                pos += n_lb
            for con, o in zip(nlp.eq_cons, S.nl_eq_offsets):
                cd = con.constraint_dim(nlp.layout)
                lam_flat = lam_flat.at[o : o + cd].set(lam_c[pos : pos + cd])
                pos += cd
            return lam_flat

        def resolve(rhs_z, rhs_c_flat):
            dz, lam_stack, lam_c, dg, _ = full_solve_extra(rhs_z, rhs_c_flat)
            return (
                jnp.concatenate([dz.reshape(-1), dg]),
                pack_lam(lam_stack, lam_c),
            )

        def resolve_many(rhs_z_stack, rhs_c_stack):
            """Solve R extra systems against the stored factorization in ONE
            fused sweep. The sweep streams the stage factors (P, Lv, Kg, Mvs)
            from memory once for all R right-hand sides — SOC + restoration
            share a single pass instead of paying factor bandwidth twice."""
            R = rhs_z_stack.shape[0]
            rhs_z_blks = jax.vmap(
                lambda rz, rc: _rho_adjust(rz[: N * d].reshape(N, d), rc)
            )(rhs_z_stack, rhs_c_stack)
            rgs = rhs_z_stack[:, N * d :]
            q1 = -rhs_z_blks  # (R, N, d)
            dzs1, dzv1, lam1 = RS(
                P_all,
                Lv_all,
                Kg_all,
                Mvs_all,
                L0,
                Abar_p,
                Bbar_p,
                q1[:, :, s_ix],
                q1[:, :, v_ix],
                jax.vmap(_b_dyn_pad)(rhs_c_stack),
            )
            lam0 = lam1 * cm[None]
            dz0 = (
                jnp.zeros((R, N, d), dtype)
                .at[:, :, s_ix]
                .set(dzs1)
                .at[:, :, v_ix]
                .set(dzv1)
            )
            dz, lam_stack, lam_c, dg, _ = jax.vmap(
                _combine, out_axes=(0, 0, 0, 0, None)
            )(dz0, lam0, rhs_c_stack, rgs)
            dZ = jnp.concatenate([dz.reshape(R, -1), dg], axis=1)
            return dZ, jax.vmap(pack_lam)(lam_stack, lam_c)

        resolve.many = resolve_many

        # the main solution came out of the fused sweep (last RHS slot)
        dz, lam_stack, lam_c, dg, ok_s = _combine(
            dz_all[m_c + n_g], lamS[m_c + n_g], rhs_c, rg_main
        )
        dZ = jnp.concatenate([dz.reshape(-1), dg])
        lam_plus = pack_lam(lam_stack, lam_c)
        ok = ok & ok_s & jnp.all(jnp.isfinite(dZ)) & jnp.all(jnp.isfinite(lam_plus))

        if self._lbfgs is not None:
            # Sherman–Morrison–Woodbury for the compact L-BFGS low-rank term:
            # the factored system K₀ used W₀ = σI; the true model is
            # W = σI − UᵀM⁻¹U, i.e. K = K₀ + Ṽ·(−M⁻¹)·Ṽᵀ with Ṽ = [U; 0]ᵀ.
            # K⁻¹b = K₀⁻¹b − K₀⁻¹Ṽ (−M + ṼᵀK₀⁻¹Ṽ)⁻¹ ṼᵀK₀⁻¹b — 2m extra
            # right-hand sides through one fused resolve sweep + a (2m)²
            # dense solve. ``resolve``'s sign convention (it returns the
            # step for rhs (b_z, b_c) with the same orientation as the main
            # solve) cancels out: Solve = s·K₀⁻¹ with s = ±1 enters C and
            # the correction once each, so the formulas below hold for the
            # validated s = +1 (see tests/test_lbfgs.py riccati-vs-dense
            # agreement).
            _sigma, _U, _M = self._lbfgs
            _R = _U.shape[0]
            Xz, Xlam = resolve_many(
                _U, jnp.zeros((_R,) + rhs_c.shape, dtype)
            )
            C = -_M + _U @ Xz.T
            base_resolve = resolve

            def _smw_correct(xz, xlam):
                w = jnp.linalg.solve(C, _U @ xz)
                return xz - Xz.T @ w, xlam - Xlam.T @ w

            dZ, lam_plus = _smw_correct(dZ, lam_plus)
            ok = (
                ok
                & jnp.all(jnp.isfinite(dZ))
                & jnp.all(jnp.isfinite(lam_plus))
            )

            def resolve_lbfgs(rhs_z, rhs_c_flat):
                xz, xlam = base_resolve(rhs_z, rhs_c_flat)
                return _smw_correct(xz, xlam)

            def resolve_lbfgs_many(rhs_z_stack, rhs_c_stack):
                xz, xlam = resolve_many(rhs_z_stack, rhs_c_stack)
                w = jnp.linalg.solve(C, (_U @ xz.T))  # (2m, R)
                return xz - (Xz.T @ w).T, xlam - (Xlam.T @ w).T

            resolve_lbfgs.many = resolve_lbfgs_many
            resolve = resolve_lbfgs

        return dZ, lam_plus, ok, delta, resolve


class RiccatiOps:
    """Operator backend using the block-structured Riccati KKT solve."""

    def __init__(self, nlp: CanonicalNLP):
        struct = analyze(nlp)
        if struct is None:
            raise ValueError("problem is not Riccati-eligible")
        self.nlp = nlp
        self.struct = struct

    def prepare(self, Z, lam, nu, cache=None, gauss_newton=False,
                stagewise=False, skip_hessian=False) -> _RiccatiCtx:
        # skip_hessian (L-BFGS mode): AD Hessian blocks are skipped; the
        # quasi-Newton model arrives via ctx.set_lbfgs as σI + a low-rank
        # SMW correction threaded through the O(N) factorization — the
        # Riccati analog of MadNLP's CompactLBFGS
        # (`/root/reference/ext/MadNLPSolverExt/utils.jl:11-110`)
        return _RiccatiCtx(
            self.nlp, self.struct, Z, lam, nu, cache,
            gauss_newton, stagewise, skip_hessian,
        )
