"""Solver options.

The JAX analog of ``IpoptOptions``
(`/root/reference/src/solvers/ipopt_solver/options.jl:33-91`): a pytree of
numeric knobs (leaves, so a compiled solve can take different tolerances
without retracing) plus static structural switches. Field names follow Ipopt
where the concept carries over (tol, constr_viol_tol, max_iter, mu_init...).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..module import module, static_field

__all__ = ["IPMOptions"]


@module
class IPMOptions:
    # -- termination (Ipopt defaults: options.jl:34-39) -------------------- #
    tol: float = 1e-8
    # Ipopt-style conjunctive success test: the scaled overall KKT error must
    # reach `tol` AND each *unscaled* component must clear its own tolerance
    # (primal infeasibility ≤ constr_viol_tol, dual infeasibility ≤
    # dual_inf_tol, complementarity ≤ compl_inf_tol). With the defaults the
    # unscaled tests are implied by e₀ ≤ tol except when the dual scaling s_d
    # or s_c is large (huge multipliers) — exactly the case Ipopt guards.
    constr_viol_tol: float = 1e-6
    dual_inf_tol: float = 1.0
    compl_inf_tol: float = 1e-4
    acceptable_tol: float = 1e-6
    acceptable_iter: int = static_field(default=15)
    # Full Ipopt acceptable_* family (reference options.jl:40-47): a point
    # counts toward acceptable_iter only when EVERY component clears its
    # acceptable threshold — scaled overall error ≤ acceptable_tol AND
    # unscaled primal/dual/complementarity within the three knobs below AND
    # the relative objective change between successive iterates within
    # acceptable_obj_change_tol (1e20 = off, the Ipopt default; set ~1e-5
    # to stop when progress stalls at acceptable quality).
    acceptable_constr_viol_tol: float = 1e-2
    acceptable_dual_inf_tol: float = 1e10
    acceptable_compl_inf_tol: float = 1e-2
    acceptable_obj_change_tol: float = 1e20
    # Diverging-iterates exit (Ipopt `diverging_iterates_tol`, reference
    # options.jl:51): a lane whose primal iterate or slack exceeds this
    # magnitude terminates with status 6 instead of burning the iteration
    # budget on a finite-but-exploding trajectory.
    diverging_iterates_tol: float = 1e20
    # -- barrier ----------------------------------------------------------- #
    # "monotone" = Fiacco–McCormick with κ_ε inner loop (Ipopt default and
    # ours: measured best on the nonconvex bilinear benchmarks);
    # "adaptive" = LOQO centrality rule; "mehrotra" = affine-scaling probe
    # (one extra resolve per iteration). Both adaptive modes are experimental
    # — on the nonconvex benchmark suite they run MORE iterations than
    # monotone (filter globalization fights the oscillating barrier).
    mu_strategy: str = static_field(default="monotone")
    mu_init: float = 1e-1
    # barrier floor: μ never drops below max(mu_min, tol/10) — the tol/10 term
    # is Ipopt's barrier_tol_factor default; raise mu_min to stop the barrier
    # earlier (e.g. warm-started resolves at loose accuracy)
    mu_min: float = 1e-12
    kappa_mu: float = 0.2  # linear μ decrease factor
    theta_mu: float = 1.5  # superlinear μ decrease exponent
    kappa_epsilon: float = 10.0  # inner-loop tolerance κ_ε·μ
    # Optional two-regime schedule: while μ > mu_switch_factor·tol the
    # *_far constants apply and the update is floored at the switch level.
    # OFF by default (factor 0 ⇒ single classic regime). Measured on the
    # N=51 bilinear family: a uniformly aggressive κ_ε=100/κ_μ=0.1 halves
    # the acceptable-band iteration tail (p90 69→27, max 119→41 — what
    # bench.py passes explicitly), but as a *default* the two-regime hybrid
    # loses both ways: the strict-tol endgame pays ~12× iterations to
    # recover centering after the loose phase (golden f64: 223 vs 19), and
    # the switch floor alone costs band tail (p90 27→38). Keep the base
    # schedule for general use; pass aggressive constants per solve when
    # targeting an acceptable band.
    kappa_epsilon_far: float = 0.0  # 0 = inherit kappa_epsilon
    kappa_mu_far: float = 0.0  # 0 = inherit kappa_mu
    mu_switch_factor: float = 0.0  # 0 = classic single-regime (default)
    tau_min: float = 0.99  # fraction-to-boundary
    kappa_sigma: float = 1e10  # dual safeguard clamp
    # "least_squares": initialize equality multipliers from one extra KKT
    # solve at the start point (min ‖∇f + Jᵀλ‖ in the (W+Σ)⁻¹ metric),
    # discarded when ‖λ‖∞ > lam_init_max — Ipopt's
    # constr_mult_init_max/least-square-duals behavior. "zero": λ₀ = 0.
    # Measured on the N=51 bilinear benchmark family (B=64, f64, tol 1e-8):
    # least_squares HALVES the convergence rate (18/64 vs 36/64 at
    # max_iter=200) — even small λ₀ feeds the indefinite bilinear dynamics
    # Hessian into early iterations and triggers heavy δ_w regularization.
    # Like the adaptive-μ experiments, it stays available but off.
    dual_init: str = static_field(default="zero")
    lam_init_max: float = 1e3
    # Lagrangian-Hessian model (static: changes the traced graph; the Ipopt
    # knob of the same name, `options.jl:74`, chooses exact vs L-BFGS — here
    # the approximation is Gauss-Newton instead, which fits the OCP structure).
    # "exact": full ∇²L including λ/ν-weighted constraint curvature.
    # "gauss_newton": objective curvature only — PSD by construction, so the
    # δ_w inertia ladder almost never fires, and `prepare` skips every
    # second-order AD pass through the dynamics (the single most expensive
    # stage). On equality dynamics the local rate degrades from quadratic to
    # linear with contraction ∝ ‖λᵀ∇²c‖/σ_min(H), but on the bilinear family
    # the dropped curvature is exactly the indefinite term that caused the
    # gauge-valley oscillation (see delta_w_mu_scale): measured on the N=51
    # family (B=64, f32, tol=1e-6), med/p90/max iterations 89/117/165 (exact)
    # → 16/29/98 (GN) at identical 64/64 convergence, and each iteration is
    # ~25% cheaper. Exact stays the default for generality (GN can stall when
    # constraint curvature dominates, e.g. strongly nonlinear dynamics with
    # large multipliers); the bilinear benchmarks pass gauss_newton.
    # "lbfgs": compact limited-memory BFGS (MadNLP's CompactLBFGS analog,
    # `/root/reference/ext/MadNLPSolverExt/utils.jl:11-110`): no second-order
    # AD at all — the Lagrangian curvature is modeled from
    # `limited_memory_max_history` (s, y) pairs in the Byrd–Nocedal–Schnabel
    # compact form. On the dense backend it is materialized once per
    # iteration; on the Riccati backend (r5) it stays in compact low-rank
    # form — σI in the stage blocks plus a Sherman–Morrison–Woodbury
    # correction threaded through the factored O(N) solve (2m extra RHS in
    # one fused sweep + a (2m)² dense solve), so large-N L-BFGS keeps the
    # O(N) factorization. The middle option for user objectives with
    # expensive exact curvature and no Gauss-Newton structure.
    hessian_approximation: str = static_field(default="exact")
    # L-BFGS memory (static: sizes the pair buffers; MadNLP default 6).
    limited_memory_max_history: int = static_field(default=6)
    # Indefinite/degenerate-curvature repair for the EXACT mode (static):
    # "inertia": classic global δ_w ladder only (Ipopt §3.1 behavior).
    # "stagewise": additionally shift each knot's Hessian block past its own
    # estimated λ_min on every factorization (shifted power iteration —
    # batched matvecs, no eigh), so one knot's saddle or gauge
    # valley no longer requires damping every stage's Newton step; the δ_w
    # ladder stays as the certified backstop. Riccati backend only (the
    # dense path has no stage blocks — silently ignored there).
    # "project": per-stage spectral clip λ → max(λ, ε) (Nocedal–Wright §3.4
    # eigenvalue modification; batched eigh per stage, so costlier per
    # factorization than the shift but identity on PD stages). "flip":
    # λ → max(|λ|, ε) (saddle-free-Newton style).
    # Measured on the N=51 free-time bilinear family (B=32, CPU f32,
    # tol=1e-6, exact, med/p90/max): 94/112/173 ("inertia") → 85/106/141
    # ("stagewise") → 22/35/60 ("project") / 24/36/56 ("flip") at identical
    # 32/32 convergence and agreeing optima — "project" closes the gap to
    # Gauss-Newton's ~16-20 to ~1.3× WITHOUT GN's structural assumption.
    # Why: the Levenberg shift raises every eigenvalue of an indefinite
    # stage by −λ̂_min, damping its positive-curvature directions too; the
    # clip modifies only the offending eigenvalues. On the benign regime the
    # asymmetry repeats: cartpole "stagewise" 9 → 41 iterations (always-on
    # shift damps productive Newton steps) but "project" only 9 → 11 (the
    # clip is identity on PD stages, the +2 is the ε floor on its
    # near-singular stages). "floor": experimental selective clip (raise
    # only near-zero eigenvalues) — measured NOT to retain project's win,
    # see ops_riccati._stage_project.
    # "auto" (default, r5): resolved at solve dispatch, currently always to
    # "inertia". Is project's iteration win worth its per-iteration cost
    # (a per-stage eigh) as a default? Measured: it wins ONLY on free-time
    # regulator families (med 21 vs 89 iterations with 30% inertia
    # non-convergence), and as a default regresses everything adjacent:
    # goal/infidelity objectives grind (25 iters → stuck at 3e-3),
    # strict-tol endgames cap near its ε floor, and the modified model can
    # change the basin — breaking riccati≡dense agreement. Full data and
    # the explicit-opt-in guidance live at the resolution site
    # (solve.py::_solve_impl).
    hessian_regularization: str = static_field(default="auto")
    # Mixed-precision residual refinement (static: changes the traced graph).
    # When the solve dtype is f32, evaluate the cancellation-limited
    # quantities — c_eq/c_in, ∇f, the dual residual ∇f+Jᵀλ+Jᵀν−zL+zU, the
    # condensed KKT right-hand side, and the full-step line-search trial —
    # in f64 and cast the *small results* back to f32.
    # The KKT solve runs in incremental-multiplier form (RHS shifted by the
    # f64 Jᵀλ so it is the small barrier dual residual, which f32 represents
    # to full relative precision) — textbook iterative refinement with an f32
    # factorization and f64 residuals. Pushes the f32 KKT floor from ~1e-4
    # to the Z-quantization floor (~1e-6 at ‖Z‖≈1) at a fraction of the cost
    # of a full-f64 solve: only ~8 residual-pass equivalents per iteration
    # run in f64; Jacobians, Hessians, and the factorization stay f32.
    # Requires jax_enable_x64. No-op when the solve dtype is already f64.
    refine_residuals: bool = static_field(default=False)
    # Compensated f32 residual arithmetic (static): error-free transforms
    # (two-sum / Veltkamp-split two-prod) on the two cancellation-limited
    # MEASUREMENTS of the f32 path — the dual-residual sum ∇f+Jᵀλ+Jᵀν−zL+zU
    # (five O(1) terms cancelling to O(tol)) and the complementarity products
    # d·z − μ (each product ≈ μ only by cancellation). Unlike
    # refine_residuals this needs NO f64 emulation — each transform is a few
    # extra f32 ops that recover the rounding of the cancelling additions /
    # products exactly (the residual floor then tracks the rounding of the
    # *inputs*, not of the arithmetic). No-op on the f64 path.
    compensated_residuals: bool = static_field(default=False)
    bound_push: float = 1e-2  # κ₁: push initial point inside bounds
    bound_frac: float = 1e-2  # κ₂
    slack_min: float = 1e-8
    # -- line search ------------------------------------------------------- #
    eta_ls: float = 1e-4  # Armijo constant
    # Relative θ-growth cap on step acceptance: reject any trial with
    # θ_trial > max(theta_growth_cap·θ0, theta_min). Wächter–Biegler f-type
    # steps have no such cap (only the global θ_max and the filter), and on
    # flat nonconvex landscapes that allows a cycle: an f-type step decreases
    # φ while multiplying θ by ~100, the next iterations pull θ back down,
    # the filter was reset on a μ update, repeat. 0 disables (classic rule).
    theta_growth_cap: float = 0.0
    max_ls: int = static_field(default=10)
    # Second-order-correction trials per iteration (static; Ipopt `max_soc`,
    # default 4 there). Here the SOC rides the parallel trial grid, so the
    # meaningful values are 1 (one SOC direction, the default — Ipopt's
    # further SOC rounds refine the same idea sequentially, which a lockstep
    # batch cannot afford) and 0 (skip the SOC resolve entirely — saves one
    # multi-RHS factor sweep per iteration on problems where SOC never
    # fires; the α_min fallback and restoration trials keep running).
    max_soc: int = static_field(default=1)
    # Non-monotone (Grippo-style) acceptance memory: the φ reference in the
    # Armijo/sufficient-decrease tests is the max over the last `ls_memory`
    # iterates at the current barrier value (history resets on μ updates,
    # like the filter). 1 = classic monotone Wächter–Biegler. Cycling is
    # bounded because f-type classification stays STRICT (relative to the
    # current φ), so every relaxed acceptance augments the filter.
    ls_memory: int = static_field(default=1)
    # -- restoration (feasibility fallback folded into the trial grid) ------ #
    # When the filter line search rejects every candidate, the deepest
    # `n_rest_trials` grid slots are re-purposed as trials of a pure
    # feasibility direction (min ½dzᵀ(W+Σ)dz s.t. J dz = −c, reusing the
    # iteration's KKT factorization) accepted on θ-decrease alone — the
    # lockstep-batch analog of Ipopt's restoration phase (which the reference
    # inherits via MOI, `src/solvers/ipopt_solver/callbacks.jl:194-200`).
    rest_theta_factor: float = 0.05  # θ sufficient-decrease slope at full step
    rest_stall_kappa: float = 0.95  # θ ratio counting a restoration step as stalled
    inf_du_tol: float = 1e-4  # feasibility-gradient scale in the infeasibility test
    infeasibility_iter: int = static_field(default=5)
    n_rest_trials: int = static_field(default=3)
    # -- inertia regularization ------------------------------------------- #
    delta_w_init: float = 1e-8
    delta_w_max: float = 1e10
    delta_w_factor: float = 8.0  # κ_w⁺ (Ipopt); first-ever bump uses ×100
    # κ_w⁻ (Ipopt's 1/3): the next iteration's first factorization probes at
    # δ_last/delta_w_decay. 1.0 = hold δ (probe exactly where the last
    # iteration succeeded). For LOCKSTEP BATCHES the decay is a tax: a probe
    # that fails refactors the whole chunk, and with hundreds of
    # μ-desynchronized lanes some lane fails its decayed probe nearly every
    # batched iteration (profiled 2.05 factor sweeps per accepted iteration
    # at B=512 under the ÷3 decay; the δ-carry fix cut it to 1.8, holding
    # cuts it to ~1). Per-lane solves keep the Ipopt default. CAUTION:
    # holding is only safe where over-damping is cheap (short
    # acceptable-band solves like the benchmark schedule) — on a problem
    # whose early iterations legitimately need a LARGE δ that must then
    # decay away, holding freezes it and cripples the Newton rate (cartpole
    # with an artificially raised floor: 9 → 617 iterations at decay=1.0).
    delta_w_decay: float = 3.0
    delta_c: float = 1e-8
    # Unconditional proximal (Levenberg-style) floor on δ_w: the inertia
    # test cannot see *nearly*-singular curvature, so on problems with
    # gauge/flat directions (free-time bilinear: dt/x are gauge at the
    # optimum) the δ=0 Newton step along the valley is enormous and the
    # endgame oscillates for ~150 iterations. The effective floor each
    # iteration is max(delta_w_min, delta_w_mu_scale·μ) — the μ-tied form
    # keeps full Newton speed until μ (and hence the target error) is small.
    # 0/0 = classic inertia-only regularization.
    # Measured on the N=51 bilinear family (B=64, f32, strict tol=1e-6),
    # med/p90/max iterations: scale 0 → 192/264/305, 0.3 → 89/117/165,
    # 1.0 → 82/101/173; f64 golden at tol=1e-8: 184 / 91 / 75. Scale 1.0
    # over-damps well-conditioned endgames (cartpole stalls at 9.6e-6
    # instead of reaching 1e-7), so the default is 0.3 — nearly the full
    # degenerate-family win with no endgame loss. The aggressive
    # acceptable-band schedule is the one regime any floor slightly hurts —
    # bench.py sets delta_w_mu_scale=0 there.
    delta_w_min: float = 0.0
    delta_w_mu_scale: float = 0.3
    # Oscillation watchdog on the proximal floor: delta_w_mu_scale·μ is
    # sized for the TYPICAL gauge valley, but a valley whose curvature sits
    # just above the floor still grinds — the lane accepts only tiny
    # backtracked steps (α ≪ α_max) for hundreds of iterations while μ (and
    # with it the floor) stays frozen because the inner loop never clears
    # κ_ε·μ. After `osc_watchdog_iter` CONSECUTIVE accepted steps with
    # α < osc_small_frac·α_max, the lane's floor multiplier ratchets
    # ×osc_boost_factor (capped at osc_boost_cap; the floor stays ∝ μ so
    # the extra damping still vanishes as μ → 0). Restoration-direction
    # accepts don't count: their natural scale is α_r ≪ α_max, so a lane
    # making healthy restoration progress is not oscillating. The boost is
    # not monotone: after `osc_watchdog_iter` CONSECUTIVE near-full accepts
    # (α ≥ 0.9·α_max) it decays ÷osc_boost_factor back toward 1, so a lane
    # that ground briefly at high μ doesn't drag a 1e6× floor through all
    # later barrier phases (if it grinds again, the watchdog refires after
    # osc_watchdog_iter more iterations). Measured on the X-gate infidelity
    # problem (f64, tol=1e-7): without the watchdog the endgame oscillates
    # from iteration ~190 to the 500 cap at kkt ≈ 1e-4; with it the solve
    # converges. 0 disables. No effect when delta_w_mu_scale = 0 (the
    # boost multiplies the μ-tied term only).
    osc_watchdog_iter: int = 8
    osc_boost_factor: float = 10.0
    osc_small_frac: float = 0.25
    osc_boost_cap: float = 1e6
    # Riccati backend: augmented-Lagrangian curvature shift for knot-local
    # border rows (terminal/interior pins, nonlinear equalities). Moves the
    # curvature those constraints fix into the core so the stage-wise inertia
    # certificate matches the full KKT inertia; solution-invariant.
    border_penalty: float = 100.0
    # -- iteration limits --------------------------------------------------- #
    # DYNAMIC leaf (r4): the bound only appears in the while_loop condition,
    # so different budgets share one trace — solve_batch_compact's phases
    # (16/16/64 iterations) collapse from 3 traced+lowered IPM programs to 1
    # (the dominant share of time-to-first-solve), and re-solving with a new
    # budget never recompiles.
    max_iter: int = 1000
    # Wall-clock budget in seconds (0 = off; STATIC — toggling it changes
    # the traced graph by inserting an io_callback poll). Measured from the
    # solve's first poll, checked on the HOST every 8 iterations; a solve
    # over budget halts with status 3 and its in-flight iterate preserved.
    # The option form of callbacks.wall_clock_stop (reference analog: a
    # wall-clock AbstractIntermediateCallback, `_solvers.jl:21-59`).
    max_wall_time: float = static_field(default=0.0)
    # -- diagnostics: per-iteration jax.debug.print (static) --------------- #
    print_level: int = static_field(default=0)

    def astype(self, dtype):
        """Cast the floating-point leaves to the solve dtype (integer knobs —
        max_iter — keep their integer semantics)."""
        import jax

        def cast(x):
            if jnp.issubdtype(jnp.result_type(x), jnp.floating):
                return jnp.asarray(x, dtype=dtype)
            return x

        return jax.tree.map(cast, self)
