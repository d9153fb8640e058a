"""Per-stage IPM micro-benchmarks — the analog of the reference's evaluator
micro-benchmarks (`/root/reference/benchmark/benchmarks.jl:23-38`), but for
the stages of the on-device batched IPM iteration:

    prepare       derivative/context build (residuals, Jacobians, Hessians)
    residual      one c_eq + c_in + objective evaluation (a single LS trial)
    kkt_step      factor (with inertia retry) + border Schur + main solve
    soc_resolve   one extra solve reusing the factorization
    ls_grid       the parallel backtracking trial grid (max_ls residual evals)
    iter_marginal marginal wall cost of one full IPM iteration (finite diff
                  of max_iter)

All timings are batched (B scenarios on one GPU, the production unit of
work, f32) and reported as per-batch milliseconds. Needs a GPU.

Writes a stable-schema ``bench_report.json`` (analog of the reference's
`benchmark/BenchmarkUtils.jl:271-291` artifact) and prints one JSON line to
stdout; human-readable table goes to stderr.
"""

import json
import sys
import time


def _timeit(fn, *args, repeats=5):
    """Best-of-N wall time in ms; the first call compiles."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--gn", action="store_true", help="Gauss-Newton Hessian (the bench.py config)")
    ap.add_argument("--batch", type=int, default=0, help="override batch size")
    ap.add_argument("--no-report", action="store_true", help="don't overwrite bench_report.json")
    cli = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from directtrajopt_tpu.benchmarks import make_batched_bilinear_problems
    from directtrajopt_tpu.solvers.canonical import make_nlp
    from directtrajopt_tpu.solvers.options import IPMOptions
    from directtrajopt_tpu.solvers.solve import solve_batch

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_stages.py needs a GPU; JAX's default device is {dev.platform}")
    print(f"device: {dev.device_kind}", file=sys.stderr)

    N = 51
    B = cli.batch or 256
    gn = bool(cli.gn)
    batch = make_batched_bilinear_problems(B, N=N, feasible_start=True)
    opt = IPMOptions(
        tol=1e-5,
        acceptable_tol=5e-4,
        hessian_approximation="gauss_newton" if gn else "exact",
    )

    # a realistic mid-solve point: run 15 iterations and keep the IPM state
    res15 = solve_batch(batch, max_iter=15, tol=opt.tol,
                        acceptable_tol=opt.acceptable_tol,
                        hessian_approximation=opt.hessian_approximation)
    st = res15.ipm.state
    jax.block_until_ready(st.Z)

    # ---- stage functions, each run K times inside ONE compiled fori_loop ---- #
    # The finite difference of two in-loop trip counts cancels the dispatch
    # cost (the same method behind iter_marginal). Each trip carries a data
    # dependency so XLA cannot hoist or dedupe the work. Wide K spread:
    # sub-ms stages need (K2-K1)·cost to clear the timing noise of the two
    # loop runs.
    K1, K2 = 4, 20

    def _loop_marginal(make_body, tag):
        def runner(K):
            def run(problem, Z, lam, nu, s, zL, zU, mu, dlast):
                nlp = make_nlp(problem)
                from directtrajopt_tpu.solvers.ops_riccati import RiccatiOps

                ops = RiccatiOps(nlp)
                body = make_body(nlp, ops, Z, lam, nu, s, zL, zU, mu, dlast)
                return jnp.sum(jax.lax.fori_loop(0, K, body, Z))

            return jax.jit(jax.vmap(run, in_axes=(0,) * 9))

        args = (batch, st.Z, st.lam, st.nu, st.s, st.zL, st.zU, st.mu,
                st.delta_w_last)
        t1 = _timeit(runner(K1), *args)
        t2 = _timeit(runner(K2), *args)
        return (t2 - t1) / (K2 - K1)

    def _sigmas(nlp, ctx, Z, s, zL, zU, nu, mu, dtype):
        lb, ub = nlp.lb.astype(dtype), nlp.ub.astype(dtype)
        has_L, has_U = jnp.isfinite(lb), jnp.isfinite(ub)
        free = nlp.free_mask.astype(dtype)
        mask_L = has_L & (free > 0)
        mask_U = has_U & (free > 0)
        dL = jnp.where(has_L, Z - lb, 1.0)
        dU = jnp.where(has_U, ub - Z, 1.0)
        SigL = jnp.where(mask_L, zL / dL, 0.0)
        SigU = jnp.where(mask_U, zU / dU, 0.0)
        Sig = (SigL + SigU) * free
        D = nu / s if nlp.n_in else jnp.zeros((0,), dtype=dtype)
        g_hat = (
            ctx.grad_f
            - jnp.where(mask_L, mu / dL, 0.0)
            + jnp.where(mask_U, mu / dU, 0.0)
        )
        if nlp.n_in:
            g_hat = g_hat + ctx.JiT(mu / s + D * (ctx.c_i + s))
        return Sig, D, free * g_hat

    def mk_residual(nlp, ops, Z, lam, nu, s, zL, zU, mu, dlast):
        def body(i, z):
            v = jnp.sum(nlp.c_eq(z)) + jnp.sum(nlp.c_in(z)) + nlp.objective(z)
            return z * (1.0 + 1e-30 * v)

        return body

    def mk_prepare(nlp, ops, Z, lam, nu, s, zL, zU, mu, dlast):
        def body(i, z):
            ctx = ops.prepare(z, lam, nu, gauss_newton=gn)
            v = jnp.sum(ctx.QW) + jnp.sum(ctx.Jr) + jnp.sum(ctx.grad_f)
            return z * (1.0 + 1e-30 * v)

        return body

    def mk_kkt(nlp, ops, Z, lam, nu, s, zL, zU, mu, dlast):
        dtype = Z.dtype
        ctx = ops.prepare(Z, lam, nu, gauss_newton=gn)
        Sig, D, g0 = _sigmas(nlp, ctx, Z, s, zL, zU, nu, mu, dtype)

        def body(i, z):
            g = g0 * (1.0 + 1e-30 * jnp.sum(z))
            dZ, lam_p, ok, delta, _ = ctx.kkt_step(
                Sig, D, g, -ctx.c_e, dlast, opt.astype(dtype)
            )
            return z * (1.0 + 1e-30 * jnp.sum(dZ))

        return body

    def mk_kkt_soc(nlp, ops, Z, lam, nu, s, zL, zU, mu, dlast):
        dtype = Z.dtype
        ctx = ops.prepare(Z, lam, nu, gauss_newton=gn)
        Sig, D, g0 = _sigmas(nlp, ctx, Z, s, zL, zU, nu, mu, dtype)

        def body(i, z):
            g = g0 * (1.0 + 1e-30 * jnp.sum(z))
            dZ, lam_p, ok, delta, resolve = ctx.kkt_step(
                Sig, D, g, -ctx.c_e, dlast, opt.astype(dtype)
            )
            rz2 = jnp.stack([-g, -g0])
            rc2 = jnp.stack([-ctx.c_e, -0.5 * ctx.c_e])
            dZ2, _ = resolve.many(rz2, rc2)
            return z * (1.0 + 1e-30 * (jnp.sum(dZ) + jnp.sum(dZ2)))

        return body

    def mk_ls_grid(nlp, ops, Z, lam, nu, s, zL, zU, mu, dlast):
        dtype = Z.dtype
        alphas = 0.5 ** jnp.arange(1, 11, dtype=dtype)

        def body(i, z):
            dZ = jnp.sin(z)  # synthetic direction; cost is evaluation-bound

            def trial(a):
                Zt = nlp.apply_pins(z + a * dZ)
                return (
                    nlp.objective(Zt)
                    + jnp.sum(jnp.abs(nlp.c_eq(Zt)))
                    + jnp.sum(jnp.abs(nlp.c_in(Zt)))
                )

            v = jnp.sum(jax.vmap(trial)(alphas))
            return z * (1.0 + 1e-30 * v)

        return body

    stages = {
        "prepare": mk_prepare,
        "residual": mk_residual,
        "kkt_step": mk_kkt,
        "kkt_step+soc2": mk_kkt_soc,
        "ls_grid10": mk_ls_grid,
    }

    # noise floor of the finite-difference method itself: the marginal of an
    # empty loop body should be 0; its measured magnitude (3 trials, worst
    # case) bounds the error on every stage number below
    def mk_noop(nlp, ops, Z, lam, nu, s, zL, zU, mu, dlast):
        def body(i, z):
            return z * (1.0 + 1e-30 * jnp.sum(z))

        return body

    noise = max(abs(_loop_marginal(mk_noop, "noop")) for _ in range(3))
    print(f"{'noise_floor':16s} {noise:8.2f} ms / batch of {B}", file=sys.stderr)

    report = {}
    below_noise = []
    for name, mk in stages.items():
        ms = _loop_marginal(mk, name)
        report[name] = round(ms, 3)
        flag = ""
        if abs(ms) < 2.0 * noise:
            below_noise.append(name)
            flag = "  (below noise floor — not meaningful)"
        print(f"{name:16s} {ms:8.2f} ms / batch of {B}{flag}", file=sys.stderr)

    # marginal per-iteration cost of the full IPM body
    def run_k(k):
        r = solve_batch(batch, max_iter=k, tol=1e-20, acceptable_tol=1e-20,
                        hessian_approximation=opt.hessian_approximation)
        return r.kkt_error

    t10 = _timeit(run_k, 10, repeats=3)
    t30 = _timeit(run_k, 30, repeats=3)
    per_iter = (t30 - t10) / 20.0
    report["iter_marginal"] = round(per_iter, 3)
    print(f"{'iter_marginal':16s} {per_iter:8.2f} ms / batch of {B}", file=sys.stderr)

    # FLOPs per batched IPM iteration from XLA's own cost analysis of the
    # compiled program (the while_loop body is counted once = one lockstep
    # iteration over the whole batch), over the measured marginal iteration
    # wall. A share of a peak needs a peak table keyed by device_kind.
    flops = None
    try:
        lowered = jax.jit(
            lambda b: solve_batch(
                b, max_iter=1, tol=1e-20, acceptable_tol=1e-20,
                hessian_approximation=opt.hessian_approximation,
            ).kkt_error
        ).lower(batch)
        ca = lowered.compile().cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        flops_iter = float(ca.get("flops", 0.0)) if ca else 0.0
        if flops_iter:
            flops = {
                "flops_per_batch_iteration": flops_iter,
                "flops_per_lane_iteration": flops_iter / B,
                "achieved_flops_per_s": flops_iter / (per_iter * 1e-3),
            }
            print(f"{'flops':16s} {flops_iter/B/1e6:8.2f} MFLOP/lane-iter", file=sys.stderr)
    except Exception as e:  # cost analysis is best-effort per backend
        print(f"cost_analysis unavailable: {e}", file=sys.stderr)

    payload = {
        "schema": "dtx-bench-stages-v4",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "batch": B,
        "N": N,
        "stages_ms": report,
        "gauss_newton": gn,
        # self-describing accuracy: stage marginals with |value| below twice
        # this floor are indistinguishable from measurement noise
        "noise_floor_ms": round(noise, 3),
        "below_noise": below_noise,
        "flops": flops,
    }
    if not cli.no_report:
        with open("bench_report.json", "w") as f:
            json.dump(payload, f, indent=1)
    print(json.dumps({"metric": "iter_marginal_ms_b%d" % B,
                      "value": report["iter_marginal"], "unit": "ms",
                      "vs_baseline": None}))


if __name__ == "__main__":
    main()
