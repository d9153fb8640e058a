"""Pre-populate the persistent XLA compile cache for the headline shapes.

A cold start compiles the headline pipeline's two large programs (the GN
seek and the exact-Hessian polish). This tool pays that cost once, ahead of
time, into the compile cache (``utils/compile_cache.py``); every later
``python bench.py`` or ``python chip_smoke.py`` at the same shapes on the
same kind of device then loads them from the cache.

The programs are compiled AOT against abstract inputs (``jit.lower(...)
.compile()``) — no solve runs, only compilation — and land in the same
persistent cache the runtime consults.

Run:  python tools/warm_cache.py            (headline shapes, B=8192)
      python tools/warm_cache.py 2048       (another batch size)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    from directtrajopt_tpu.benchmarks import headline_config, make_headline_batch
    from directtrajopt_tpu.solvers.solve import _compact_runner, _merge_options
    from directtrajopt_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    print(f"device: {dev.device_kind}; compile cache: {enable_compile_cache()}",
          file=sys.stderr)

    B = int(sys.argv[1]) if len(sys.argv) > 1 else None
    cfg = headline_config(batch=B)
    batch = make_headline_batch(cfg)

    def abs_of(t):
        return jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)
            if hasattr(x, "shape")
            else x,
            t,
        )

    p1 = dict(cfg["phase1_kw"])
    phases1, chunk1 = p1.pop("phases"), p1.pop("chunk")
    opts1 = _merge_options(None, p1)
    r1_fn = _compact_runner("auto", tuple(phases1), chunk1, False)

    t0 = time.time()
    res_shape = jax.eval_shape(r1_fn, batch, opts1, None)
    print(f"trace (eval_shape): {time.time() - t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    r1_fn.lower(abs_of(batch), opts1, None).compile()
    print(f"seek stage compiled: {time.time() - t0:.1f}s", file=sys.stderr)

    p2 = dict(cfg["polish_kw"])
    phases2, chunk2 = p2.pop("phases"), p2.pop("chunk")
    p2.pop("carry_duals", None)
    opts2 = _merge_options(None, p2)
    r2_fn = _compact_runner("auto", tuple(phases2), chunk2, True)
    t0 = time.time()
    r2_fn.lower(
        abs_of(res_shape.problem),
        opts2,
        abs_of(res_shape.ipm.state.best_kkt_warm),
    ).compile()
    print(f"polish stage compiled: {time.time() - t0:.1f}s", file=sys.stderr)
    print("cache warmed — bench.py / chip_smoke.py now start warm")


if __name__ == "__main__":
    main()
