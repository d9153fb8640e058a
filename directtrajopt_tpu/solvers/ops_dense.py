"""Dense NLP operator backend.

The IPM consumes derivative information through an operator interface so the
KKT linear algebra is swappable:

    ctx = ops.prepare(Z, lam, nu)     # evaluate residuals + derivatives at Z
    ctx.c_e, ctx.c_i, ctx.grad_f      # residual vectors / objective gradient
    ctx.JeT(v), ctx.JiT(v), ctx.Ji(v) # Jacobian (transpose) products
    dZ, lam+, ok, delta, resolve = ctx.kkt_step(...)  # factor+solve with
                                      # inertia-regularization retry; `resolve`
                                      # reuses the factorization (for SOC)

This dense backend materializes full matrices via structured assembly and
solves the condensed KKT in augmented-Lagrangian form: by the Haynsworth
identity, Cholesky of ``M = H + δw I + JᵀJ/δc`` succeeding is exactly the
correct-inertia certificate for the regularized KKT matrix, and M solves the
system (with iterative refinement recovering the 1/δc conditioning loss).
It is the general/fallback path — exact for every problem class, best in f64
on CPU. The block-structured Riccati backend (`ops_riccati.py`) is the
batched f32 performance path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import assembly
from .canonical import CanonicalNLP

__all__ = ["DenseOps"]


def _reg_retry(factor, delta_last, opt, dtype):
    """Shared inertia-regularization retry schedule.

    Ipopt (§3.1) always probes δ=0 first; for us each probe is a full
    factorization sweep, so when regularization was needed last iteration we
    warm-start the first attempt at δ_last/3 (its *second*-attempt value)
    and skip the near-certain δ=0 failure — measured ~25-40% of IPM wall
    time on the bilinear benchmark. δ still decays ÷3 per iteration, so it
    drifts back to 0 within a few iterations once curvature turns convex.
    ``factor(δ) -> (carry..., ok)``.

    ``opt.delta_w_min`` is an unconditional proximal floor: inertia-triggered
    regularization cannot see *nearly*-singular curvature (a +1e-7 eigenvalue
    passes the Cholesky test at δ=0, and the Newton step along that direction
    is then enormous). Problems with gauge/flat directions — e.g. free-time
    bilinear problems where only u is determined at the optimum — need a
    small always-on Levenberg-style shift to bound steps along the valley."""
    delta0 = jnp.maximum(
        opt.delta_w_min,
        jnp.where(
            delta_last > 0,
            jnp.maximum(opt.delta_w_init, delta_last / opt.delta_w_decay),
            jnp.zeros((), dtype=dtype),
        ),
    )
    first = factor(delta0)
    first_bump = jnp.where(
        delta_last > 0,
        jnp.maximum(opt.delta_w_init, delta_last / opt.delta_w_decay)
        * opt.delta_w_factor,
        opt.delta_w_init * 100.0,
    )

    def cond(carry):
        delta = carry[0]
        ok = carry[-1]
        return (~ok) & (delta < opt.delta_w_max)

    def body(carry):
        delta = carry[0]
        new_delta = jnp.where(delta == 0.0, first_bump, delta * opt.delta_w_factor)
        return (new_delta,) + factor(new_delta)

    # (A "carry 3δ so the next probe lands on the δ that just succeeded"
    # variant was measured and REVERTED: it cut batched retry sweeps
    # 2.15 → 1.8 on the batched bench, but systematically over-regularizes
    # single-lane exact solves — the N=21 free-time golden went 35 → 78
    # iterations. The batched thrash is solved without it by
    # delta_w_decay=1.0 + a constant delta_w_min floor, bench.py.)
    init = (delta0,) + first
    return jax.lax.while_loop(cond, body, init)


class _DenseCtx:
    def __init__(self, nlp: CanonicalNLP, Z, lam, nu, cache=None,
                 gauss_newton=False, skip_hessian=False):
        self.nlp = nlp
        self.Z = Z
        self.grad_f = assembly.gradient(nlp, Z)
        if cache is not None:
            # residuals at Z carried from the line search that accepted it
            self.c_e, self.c_i = cache
        else:
            self.c_e = nlp.c_eq(Z)
            self.c_i = nlp.c_in(Z)
        self._Je = assembly.jac_eq(nlp, Z)
        self._Ji = assembly.jac_in(nlp, Z)
        if skip_hessian:
            # quasi-Newton mode (L-BFGS): the IPM injects the model Hessian
            # via set_hessian() after updating its curvature pairs — no
            # second-order AD runs at all
            self._W = None
        else:
            self._W = assembly.hess_lagrangian(
                nlp, Z, lam, nu, 1.0, gauss_newton=gauss_newton
            )
        self._free = nlp.free_mask.astype(Z.dtype)

    def set_hessian(self, W):
        """Install an externally-built Lagrangian-Hessian model (L-BFGS)."""
        self._W = W

    def JeT(self, v):
        return self._Je.T @ v

    def JiT(self, v):
        return self._Ji.T @ v

    def Ji(self, v):
        return (self._Ji * self._free[None, :]) @ v

    def kkt_step(self, Sig, D, g_hat, rhs_c, delta_last, opt, refine=2):
        """Factor (with retry) and solve. Returns
        (dZ, λ⁺, ok, δ_used, resolve) with resolve(rhs_z, rhs_c) reusing the
        factorization."""
        nlp = self.nlp
        f = self._free
        dtype = g_hat.dtype
        z_dim, n_eq = nlp.z_dim, nlp.n_eq
        # δc floor scales with the working precision: in f32, δc=1e-8 makes
        # JᵀJ/δc ~1e8 swamp H entirely (eps32·1e8 ≈ 10 — the Hessian
        # contributes literally nothing to the factorization and iterative
        # refinement diverges; measured: the f32 dense path floored at
        # KKT ~2.6e-3). With δc ~ √eps the augmented Cholesky is a usable
        # *preconditioner* and the refinement loop below (which targets the
        # TRUE δc=0 KKT system) restores accuracy.
        eps = jnp.finfo(dtype).eps
        delta_c = jnp.maximum(opt.delta_c, jnp.sqrt(eps) * 0.1)

        H = self._W + jnp.diag(Sig)
        if nlp.n_in:
            Jim = self._Ji * f[None, :]
            H = H + (Jim.T * D[None, :]) @ Jim
        Hbase = f[:, None] * f[None, :] * H + jnp.diag(1.0 - f)
        Jm = self._Je * f[None, :] if n_eq else self._Je

        def factor(delta_w):
            Hm = Hbase + delta_w * jnp.diag(f)
            M = Hm if n_eq == 0 else Hm + (Jm.T @ Jm) / delta_c
            L = jnp.linalg.cholesky(M)
            ok = jnp.all(jnp.isfinite(L))
            L = jnp.where(jnp.isfinite(L), L, jnp.eye(z_dim, dtype=dtype))
            return (L, ok)

        delta, L, ok = _reg_retry(factor, delta_last, opt, dtype)
        Hm = Hbase + delta * jnp.diag(f)

        def chol_solve(r):
            y = jax.scipy.linalg.solve_triangular(L, r, lower=True)
            return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)

        if n_eq == 0:

            def resolve(rhs_z, _rhs_c):
                dZ = chol_solve(rhs_z)
                for _ in range(refine):
                    dZ = dZ + chol_solve(rhs_z - Hm @ dZ)
                return dZ, jnp.zeros((0,), dtype=dtype)

        else:

            def resolve(rhs_z, rhs_c):
                def aug(rz, rc):
                    dz = chol_solve(rz + Jm.T @ (rc / delta_c))
                    lp = (Jm @ dz - rc) / delta_c
                    return dz, lp

                dZ, lam = aug(rhs_z, rhs_c)
                # refinement targets the TRUE (δc=0) KKT system — the
                # augmented solve is only the preconditioner, so each pass
                # contracts the error by ~δc·‖S⁻¹‖ and both the δc
                # perturbation and the f32 conditioning loss wash out
                for _ in range(refine):
                    r_z = rhs_z - Hm @ dZ - Jm.T @ lam
                    r_c = rhs_c - Jm @ dZ
                    ddz, dlp = aug(r_z, r_c)
                    dZ, lam = dZ + ddz, lam + dlp
                return dZ, lam

        # stacked variant: the factorization is shared, matmuls broadcast
        resolve.many = jax.vmap(resolve)

        dZ, lam_plus = resolve(-g_hat, rhs_c)
        ok = ok & jnp.all(jnp.isfinite(dZ)) & jnp.all(jnp.isfinite(lam_plus))
        return dZ, lam_plus, ok, delta, resolve


class DenseOps:
    def __init__(self, nlp: CanonicalNLP):
        self.nlp = nlp

    def prepare(self, Z, lam, nu, cache=None, gauss_newton=False,
                stagewise=False, skip_hessian=False) -> _DenseCtx:
        # `stagewise` (options.hessian_regularization) is a no-op here: the
        # dense path has no stage blocks to shift individually — a global
        # eigen-projection of W would cost a second O(z_dim³) factorization
        # per iteration. The δ_w ladder remains its inertia repair.
        return _DenseCtx(self.nlp, Z, lam, nu, cache, gauss_newton,
                         skip_hessian)
