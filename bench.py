"""Benchmark driver: certified batched 50-knot bilinear solves/s on one GPU.

Runs the reference's standard bilinear quantum-gate benchmark problem
(`/root/reference/benchmark/problem_utils.jl:10-42`, N=51, 4D state, 2
bounded drives, u→du→ddu chain, free timestep) as a scenario batch through
the certified two-stage pipeline of
:func:`directtrajopt_tpu.benchmarks.headline_config` and reports throughput.
A solve counts when its lane converged to the polish tolerance; the control
sequences of the first 64 lanes are checked against the independent scipy
golden optimum (RMS(u) < 1e-4, the reference's cross-solver bar).

Needs a GPU: with none it exits non-zero and prints no result.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...,
"device": {"platform", "kind", "count"}}. vs_baseline compares against the
reference's published single-solve Ipopt wall time of 0.616 s
(= 1.62 solves/s; `docs/src/benchmarks.md:62-66`). Diagnostics go to stderr.
"""

import json
import sys
import time

import numpy as np

N_REPS = 5


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's default device is {dev.platform}")

    from directtrajopt_tpu.benchmarks import (
        headline_config,
        make_headline_batch,
        rms_u_vs_golden,
        run_headline,
    )
    from directtrajopt_tpu.utils.compile_cache import enable_compile_cache

    print(f"device: {dev.device_kind}; compile cache: {enable_compile_cache()}", file=sys.stderr)
    cfg = headline_config()
    B = cfg["batch"]
    batch = jax.block_until_ready(make_headline_batch(cfg))

    def run():
        t0 = time.perf_counter()
        res, res_seek = run_headline(batch, cfg)
        jax.block_until_ready(res)
        return time.perf_counter() - t0, res, res_seek

    compile_s, _, _ = run()
    print(f"compile+first run: {compile_s:.1f}s", file=sys.stderr)

    times, convs = [], []
    for _ in range(N_REPS):
        wall, res, res_seek = run()
        times.append(wall)
        convs.append(int(np.asarray(res.converged).sum()))
    rates = np.asarray(convs) / np.asarray(times)
    solves_per_s = float(np.median(rates))
    q1, q3 = np.percentile(rates, [25, 75])
    conv = np.asarray(res.converged)
    kkt_cert = float(np.asarray(res.kkt_error)[conv].max())
    n_p2 = int((np.asarray(res_seek.iterations) > cfg["phase1_kw"]["phases"][0][0]).sum())
    rms_g = rms_u_vs_golden(res, n_lanes=min(64, B))
    print(
        f"batch={B} walls={[round(t, 3) for t in times]} converged={int(conv.sum())}/{B} "
        f"(seek stragglers {n_p2}); certified kkt <= {kkt_cert:.1e}; "
        f"rms_u_vs_golden (first {min(64, B)} lanes) {rms_g:.2e}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "bilinear_n51_certified_solves_per_s",
        "value": solves_per_s,
        "unit": "solves/s/gpu",
        "vs_baseline": solves_per_s * 0.616,
        "spread": float(q3 - q1),
        "compile_s": compile_s,
        "rms_u_vs_golden": rms_g,
        "kkt_certified": kkt_cert,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    main()
