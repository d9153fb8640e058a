"""Knot-count / state-dimension scaling sweep.

The analog of the reference's memory-scaling benchmark
(`/root/reference/benchmark/benchmarks.jl:148-258`: N∈{25,51,101} ×
dim∈{4,8,16}, max_iter=50) — but batched: each cell solves a whole scenario
batch per cell and reports per-solve wall time, versus the reference's
published per-cell Ipopt seconds (`docs/src/benchmarks.md:114-124`).

Usage: python bench_sweep.py [batch]    (markdown table on stdout; needs
a GPU, which only the per-cell child processes open)
"""

import sys


REFERENCE_IPOPT_S = {  # docs/src/benchmarks.md:116-124 (median of 3 seeds)
    (25, 4): 0.81, (25, 8): 0.92, (25, 16): 8.89,
    (51, 4): 1.61, (51, 8): 8.16, (51, 16): 58.63,
    (101, 4): 3.54, (101, 8): 0.66, (101, 16): 114.43,
}


CELL_TIMEOUT_S = 2400


def _run_cell_subprocess(N, dim, B_cell):
    """One cell in its own OS process, so that this parent never opens the
    GPU (a second JAX process on the card fails for want of memory) and one
    cell's failure cannot take the others with it. The persistent compile
    cache keeps the re-spawn cost at one cache lookup."""
    import json as _json
    import os as _os
    import subprocess
    import sys as _sys

    repo = _os.path.dirname(_os.path.abspath(__file__))

    code = f"""
import json, time, sys
import numpy as np, jax
sys.path.insert(0, {repo!r})
if jax.devices()[0].platform != "gpu":
    sys.exit("bench_sweep.py needs a GPU")
from directtrajopt_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp
from directtrajopt_tpu.benchmarks import make_scaled_problem
from directtrajopt_tpu.solvers.solve import solve_batch_compact
kwargs = dict(tol=1e-5, acceptable_tol=5e-4, acceptable_iter=5,
              hessian_approximation="gauss_newton",
              kappa_epsilon=100.0, kappa_mu=0.1)
N, dim, B = {N}, {dim}, {B_cell}
probs = [make_scaled_problem(N=N, state_dim=dim, seed=42 + i) for i in range(B)]
batch = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *probs)
# uncapped schedule: the compact straggler phases run to a 378-iteration
# total budget so the per-solve wall is a time-to-solution whenever
# conv>=90%
def run_cell(b):
    return solve_batch_compact(
        b, phases=((20, None), (30, 1e-3), (72, 1e-3), (256, 1e-3)),
        chunk=128, **kwargs)
t0 = time.time()
res = jax.block_until_ready(run_cell(batch))
compile_s = time.time() - t0
t0 = time.time()
res = jax.block_until_ready(run_cell(batch))
wall = time.time() - t0
it = np.asarray(res.iterations)
print(json.dumps(dict(wall=wall, compile_s=compile_s,
                      conv=int(np.asarray(res.converged).sum()),
                      it_med=float(np.median(it)),
                      it_p90=float(np.percentile(it, 90)))))
"""
    try:
        r = subprocess.run(
            [_sys.executable, "-c", code],
            capture_output=True,
            text=True,
            timeout=CELL_TIMEOUT_S,
        )
    except subprocess.TimeoutExpired:
        return None, "timeout"
    if r.returncode != 0:
        tail = r.stderr.strip().splitlines()[-1:] or ["?"]
        return None, tail[0][:120]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("{")][-1]
    return _json.loads(line), None


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 256

    rows = []
    # the reference grid, plus long-horizon rows (201/501 knots) on the
    # O(N) Riccati + chain-promotion path — the reference publishes no
    # cells there (its sweep stops at N=101)
    cells = [(N, dim) for N in (25, 51, 101) for dim in (4, 8, 16)]
    cells += [(201, 4), (201, 8), (501, 4)]
    for N, dim in cells:
        B_cell = B if N <= 101 else max(32, B // (2 if N <= 201 else 4))
        out, err = _run_cell_subprocess(N, dim, B_cell)
        ref = REFERENCE_IPOPT_S.get((N, dim))
        if out is None:
            print(f"N={N} dim={dim}: FAILED ({err})", file=sys.stderr)
            rows.append((N, dim, None, 0, B_cell, ref, None, None))
            continue
        per_solve = out["wall"] / B_cell
        conv = out["conv"]
        # a cell only counts as SOLVED (and its per-solve wall as a true
        # time-to-solution) when >=90% of lanes reach the acceptable level
        solved90 = conv >= 0.9 * B_cell
        spd = (ref / per_solve) if (ref and solved90) else None
        rows.append(
            (N, dim, per_solve, conv, B_cell, ref, spd, out["compile_s"],
             out["it_med"], out["it_p90"], solved90)
        )
        ref_s = f"ref Ipopt {ref}s" if ref else "no ref cell"
        print(
            f"N={N} dim={dim}: {per_solve*1000:.1f} ms/solve "
            f"({conv}/{B_cell} conv, it med/p90 {out['it_med']:.0f}/"
            f"{out['it_p90']:.0f}, {ref_s}, "
            f"{f'{spd:.0f}x' if spd else 'n/a'})",
            file=sys.stderr,
        )

    print("| N | dim | ms/solve (uncapped) | conv | it med/p90 | "
          "ref Ipopt s | speedup |")
    print("|--:|--:|--:|--:|--:|--:|--:|")
    for N, dim, per, conv, B_, ref, spd, _, im, ip, s90 in rows:
        per_s = f"{per*1000:.1f}" if per is not None else "crash"
        if per is not None and not s90:
            per_s += " (<90% conv)"
        it_s = f"{im:.0f}/{ip:.0f}" if per is not None else "—"
        print(
            f"| {N} | {dim} | {per_s} | {conv}/{B_} | {it_s} | "
            f"{ref if ref else '—'} | {f'{spd:.0f}x' if spd else '—'} |"
        )


if __name__ == "__main__":
    main()
