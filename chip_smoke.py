#!/usr/bin/env python3
"""Smoke test of the certified batched IPM on an NVIDIA GPU.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # the sharded pipeline on four cards

Phases, in order; the first failure exits non-zero and prints no result:

1. Device: the default JAX device must be a GPU (x64 stays off). Prints
   the card's name and power limit from ``nvidia-smi``.
2. Parity: the batched f32 Riccati factor+solve and resolve against the
   same sweeps in f64 at the headline widths (B=8192 lanes, N=51, ns=8,
   nv=3, the seek's R), and the closed-form window Jacobian against f64
   ``jacfwd`` of ``ops.expm.expv_taylor``, all under "highest" matmul
   precision as the solver runs them.
3. Main path: :func:`directtrajopt_tpu.benchmarks.run_headline` on the
   B=8192 batch, checked for convergence, certified KKT and RMS(u) against
   the scipy golden optimum.

With ``--four`` only the device phase and the sharded phase run: both
stages through ``solve_batch_compact_sharded`` over a 1-D mesh of four
cards at 4×8192 lanes, compared lane for lane with a one-card solve of a
2048-lane sample from each shard (8192 lanes: the one-card main path's
program, so a warm compile cache serves it).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# parity tolerances. Riccati: f32 round-off (1.2e-7) grown over a 51-stage
# sweep with stage-block condition numbers near 1e2 (a TF32 product would
# miss it by orders of magnitude). Window Jacobian: a
# 6-term Horner chain of 4×4 products in f32 against f64.
RICCATI_RTOL = 1e-4
JAC_RTOL = 1e-5
# main path
MIN_CONVERGED = 0.99
MAX_KKT = 1e-6
MAX_RMS_U = 1e-4


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def device_phase(n_cards):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX's default device is {devs[0].platform}")
    if len(devs) < n_cards:
        fail(f"{n_cards} GPUs needed, JAX sees {len(devs)}")
    if jax.config.jax_enable_x64:
        fail("jax_enable_x64 must stay off")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        fail(f"nvidia-smi gave nothing: {smi.stderr.strip()}")
    print(f"card: {card}")
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    return devs[: n_cards]


def _lane_rel(x, ref):
    """Max over lanes of ‖x − ref‖∞ / ‖ref‖∞ (lanes on axis 0)."""
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
    ref = np.asarray(ref, np.float64).reshape(ref.shape[0], -1)
    scale = np.maximum(np.abs(ref).max(axis=1), 1e-30)
    return float((np.abs(x - ref).max(axis=1) / scale).max())


def _stage_data(rng, B, N, ns, nv, R):
    """Convex random stage blocks (condition numbers near 1e2)."""
    def sym(x):
        return 0.5 * (x + np.swapaxes(x, -1, -2))

    Qss = sym(rng.standard_normal((B, N, ns, ns))) * 0.1 + 2.0 * np.eye(ns)
    Qsv = rng.standard_normal((B, N, ns, nv)) * 0.1
    Qvv = sym(rng.standard_normal((B, N, nv, nv))) * 0.1 + 2.0 * np.eye(nv)
    A = rng.standard_normal((B, N, ns, ns)) * 0.3
    Bm = rng.standard_normal((B, N, ns, nv)) * 0.3
    A[:, -1] = 0.0
    Bm[:, -1] = 0.0
    qs = rng.standard_normal((B, R, N, ns))
    qv = rng.standard_normal((B, R, N, nv))
    b = rng.standard_normal((B, R, N, ns))
    b[:, :, -1] = 0.0
    return [x.astype(np.float32) for x in (Qss, Qsv, Qvv, A, Bm, qs, qv, b)]


def parity_phase():
    import jax
    import jax.numpy as jnp

    from directtrajopt_tpu.ops import riccati_kernel as rk
    from directtrajopt_tpu.ops.expm import expv_taylor
    from directtrajopt_tpu.ops.expv_kernel import make_window_jac

    B, N, ns, nv = 8192, 51, 8, 3
    R_factor, R_resolve = 3, 2  # the seek's factor and resolve widths
    key = (0, 0, 0, 0, 0, 0, 1, 1)  # x and u pinned at knot 0, du free
    rng = np.random.default_rng(0)
    args = [jnp.asarray(x) for x in _stage_data(rng, B, N, ns, nv, R_factor)]
    rhs2 = [jnp.asarray(x[:, :R_resolve]) for x in _stage_data(rng, B, N, ns, nv, R_resolve)[5:]]

    with jax.default_matmul_precision("highest"):
        fs = jax.jit(jax.vmap(rk.make_factor_solve(key)))
        rs = jax.jit(jax.vmap(rk.make_resolve(key)))
        out_32 = jax.block_until_ready(fs(*args))
        res_32 = jax.block_until_ready(rs(*out_32[:5], *args[3:5], *rhs2))
        with jax.enable_x64(True):
            a64 = [jnp.asarray(np.asarray(x), jnp.float64) for x in args]
            r64 = [jnp.asarray(np.asarray(x), jnp.float64) for x in rhs2]
            out_64 = jax.block_until_ready(fs(*a64))
            res_64 = jax.block_until_ready(rs(*out_64[:5], *a64[3:5], *r64))
    if not (np.asarray(out_32[5]) == np.asarray(out_64[5])).all():
        fail("Riccati ok flags differ between f32 and f64")
    if not np.asarray(out_32[5]).all():
        fail("convex parity fixture reported a non-PD stage")
    for what, x, ref in (
        ("factor dzs", out_32[6], out_64[6]),
        ("factor dzv", out_32[7], out_64[7]),
        ("factor lam", out_32[8], out_64[8]),
        ("resolve dzs", res_32[0], res_64[0]),
        ("resolve dzv", res_32[1], res_64[1]),
        ("resolve lam", res_32[2], res_64[2]),
    ):
        err = _lane_rel(x, ref)
        print(f"parity Riccati {what}: f32 scan vs f64 scan {err:.2e} (tol {RICCATI_RTOL:.0e})")
        if not err <= RICCATI_RTOL:
            fail(f"Riccati {what} parity {err:.2e} > {RICCATI_RTOL:.0e}")

    # window Jacobian: headline dynamics (Pauli generators, |u| ≤ 0.1,
    # Δt within its bounds), order 6, free time
    from directtrajopt_tpu.benchmarks import pauli_generators

    K, order = N - 1, 6
    Gx, Gy, Gz = pauli_generators()
    Gd = np.broadcast_to(0.1 * Gz, (B, 4, 4))
    Gv = np.broadcast_to(np.stack([Gx, Gy]), (B, 2, 4, 4))
    u = rng.uniform(-0.1, 0.1, (B, K, 2))
    dt = rng.uniform(0.01, 0.5, (B, K))
    x = rng.standard_normal((B, K, 4))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    jac_args = (Gd, Gv, u, dt, x)
    with jax.default_matmul_precision("highest"):
        jac = jax.jit(jax.vmap(make_window_jac(order, True)))
        J32 = jax.block_until_ready(jac(*[jnp.asarray(a, jnp.float32) for a in jac_args]))

        def ref_one(Gd, Gv, u, dt, x):
            def f(x, u, dt):
                return expv_taylor(dt * (Gd + jnp.einsum("m,mij->ij", u, Gv)), x, order=order)

            Jx, Ju, Jt = jax.jacfwd(f, argnums=(0, 1, 2))(x, u, dt)
            return jnp.concatenate([Jx, Ju, Jt[:, None]], axis=1)

        ref = jax.vmap(jax.vmap(ref_one, in_axes=(None, None, 0, 0, 0)))
        with jax.enable_x64(True):
            J64 = jax.block_until_ready(
                jax.jit(ref)(*[jnp.asarray(a, jnp.float64) for a in jac_args])
            )
    err = _lane_rel(J32, J64)
    print(f"parity window Jacobian: f32 closed form vs f64 jacfwd {err:.2e} (tol {JAC_RTOL:.0e})")
    if not err <= JAC_RTOL:
        fail(f"window Jacobian parity {err:.2e} > {JAC_RTOL:.0e}")


def _check_solution(res, what, n_lanes=64):
    """Convergence share, certified KKT, and RMS(u) vs the golden optimum
    over the converged lanes among the first ``n_lanes``."""
    from directtrajopt_tpu.benchmarks import rms_u_per_lane

    conv = np.asarray(res.converged)
    kkt = np.asarray(res.kkt_error)
    n_conv = int(conv.sum())
    kkt_max = float(kkt[conv].max()) if n_conv else float("inf")
    rms = rms_u_per_lane(res)
    head = conv[:n_lanes]
    rms_max = float(rms[:n_lanes][head].max()) if head.any() else float("inf")
    n_far = int((rms[conv] >= MAX_RMS_U).sum())
    print(
        f"{what}: converged {n_conv}/{conv.size}, max certified kkt {kkt_max:.2e}, "
        f"rms_u_vs_golden over the {int(head.sum())} converged of the first "
        f"{n_lanes} lanes {rms_max:.2e}; converged lanes off the golden optimum "
        f"(RMS >= {MAX_RMS_U:.0e}) in the whole batch: {n_far}"
    )
    if n_conv < MIN_CONVERGED * conv.size:
        fail(f"{what}: only {n_conv}/{conv.size} lanes converged")
    if not kkt_max <= MAX_KKT:
        fail(f"{what}: certified kkt {kkt_max:.2e} > {MAX_KKT:.0e}")
    if not rms_max < MAX_RMS_U:
        fail(f"{what}: rms_u_vs_golden {rms_max:.2e} >= {MAX_RMS_U:.0e}")


def main_path_phase():
    import jax

    from directtrajopt_tpu.benchmarks import headline_config, make_headline_batch, run_headline

    cfg = headline_config()
    batch = jax.block_until_ready(make_headline_batch(cfg))

    def run():
        t0 = time.perf_counter()
        res, _ = run_headline(batch, cfg)
        jax.block_until_ready(res)
        return time.perf_counter() - t0, res

    first, res = run()
    walls = [run()[0] for _ in range(3)]
    wall = float(np.median(walls))
    n_conv = int(np.asarray(res.converged).sum())
    print(
        f"main path B={cfg['batch']}: compile+first run {first:.1f}s, median wall "
        f"{wall:.3f}s over {len(walls)} repeats {[round(w, 3) for w in walls]}, "
        f"{n_conv / wall:.1f} certified solves/s"
    )
    print("riccati path: vmapped XLA scan (the only one)")
    _check_solution(res, "main path")


def four_card_phase(devs):
    import jax

    from directtrajopt_tpu.benchmarks import headline_config, make_headline_batch, run_headline
    from directtrajopt_tpu.parallel import make_mesh, solve_batch_compact_sharded

    per_card, sample = 8192, 2048
    n = len(devs)
    cfg = headline_config(batch=n * per_card)
    batch = make_headline_batch(cfg)
    mesh = make_mesh(devs)

    t0 = time.perf_counter()
    seek = solve_batch_compact_sharded(batch, mesh=mesh, **cfg["phase1_kw"])
    res = solve_batch_compact_sharded(
        seek.problem, mesh=mesh, warm=seek.ipm.state.best_kkt_warm, **cfg["polish_kw"]
    )
    jax.block_until_ready(res)
    print(f"{n}-card sharded B={cfg['batch']}: compile+run {time.perf_counter() - t0:.1f}s")
    _check_solution(res, f"{n}-card sharded")

    idx = np.concatenate([np.arange(s * per_card, s * per_card + sample) for s in range(n)])
    sub = jax.tree.map(lambda x: jax.device_put(np.asarray(x)[idx], devs[0]), batch)
    t0 = time.perf_counter()
    one, _ = run_headline(sub, headline_config(batch=idx.size))
    jax.block_until_ready(one)
    print(f"one-card sample B={idx.size}: compile+run {time.perf_counter() - t0:.1f}s")
    _check_solution(one, "one-card sample")

    conv_s = np.asarray(res.converged)[idx]
    conv_1 = np.asarray(one.converged)
    u_s = np.asarray(res.problem.trajectory.data["u"], np.float64)[idx]
    u_1 = np.asarray(one.problem.trajectory.data["u"], np.float64)
    rms = np.sqrt(np.mean((u_s - u_1) ** 2, axis=(1, 2)))
    both = conv_s & conv_1
    print(
        f"lane for lane: converged flags agree on {int((conv_s == conv_1).sum())}/{idx.size}, "
        f"max RMS(u_sharded - u_one_card) over {int(both.sum())} lanes converged in both "
        f"{rms[both].max():.2e} (tol {MAX_RMS_U:.0e})"
    )
    if (conv_s != conv_1).mean() > 1 - MIN_CONVERGED:
        fail("sharded and one-card converged flags differ on too many lanes")
    if not rms[both].max() < MAX_RMS_U:
        fail("sharded and one-card solutions differ")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true", help="run the sharded path on four cards")
    args = ap.parse_args()

    devs = device_phase(4 if args.four else 1)
    import jax

    from directtrajopt_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}")
    if args.four:
        four_card_phase(devs)
    else:
        parity_phase()
        main_path_phase()
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d),
    }}))


if __name__ == "__main__":
    main()
