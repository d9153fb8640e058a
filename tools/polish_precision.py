#!/usr/bin/env python3
"""Time the certified polish in f64 next to the compensated-f32 one.

    python tools/polish_precision.py [batch]     # needs a GPU; default 8192

Both polishes start from the same f32 GN seek of the headline configuration
(``directtrajopt_tpu.benchmarks.headline_config``). The f64 one turns
``compensated_residuals`` off. Prints one JSON line per precision with its
compile+first-run and second-run wall times, converged count, max KKT and
median iterations.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX's default device is {dev.platform}")

    from directtrajopt_tpu.benchmarks import headline_config, make_headline_batch
    from directtrajopt_tpu.solvers.solve import cast_problem, solve_batch_compact
    from directtrajopt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = headline_config(batch=int(sys.argv[1]) if len(sys.argv) > 1 else None)
    seek = jax.block_until_ready(
        solve_batch_compact(make_headline_batch(cfg), **cfg["phase1_kw"])
    )
    for name, x64 in (("f32_compensated", False), ("f64", True)):
        with jax.enable_x64(x64):
            prob, warm, kw = seek.problem, seek.ipm.state.best_kkt_warm, dict(cfg["polish_kw"])
            if x64:
                prob = cast_problem(prob, jnp.float64)
                warm = jax.tree.map(lambda a: a.astype(jnp.float64), warm)
                kw["compensated_residuals"] = False
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                res = jax.block_until_ready(solve_batch_compact(prob, warm=warm, **kw))
                walls.append(time.perf_counter() - t0)
        conv = np.asarray(res.converged)
        print(json.dumps(dict(
            polish=name, batch=int(conv.size), device_kind=dev.device_kind,
            compile_first_s=walls[0], wall_s=walls[1], converged=int(conv.sum()),
            kkt_max=float(np.asarray(res.kkt_error)[conv].max()),
            iters_median=float(np.median(np.asarray(res.iterations))),
        )), flush=True)


if __name__ == "__main__":
    main()
