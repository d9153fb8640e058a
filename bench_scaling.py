"""Weak-scaling benchmark: solves/s/device at 1..n devices (BASELINE target
#3: ≥85% multi-host scaling efficiency).

On several GPUs this measures the real sharding overhead. With
``--emulate`` it runs on the CPU against an emulated mesh
(``--xla_force_host_platform_device_count``), which validates the sharding
mechanism; emulated devices share one socket, so wall-clock "efficiency"
there is a smoke signal, not a hardware measurement (the record is tagged
``emulated``).

For several hosts: start one process per host with
``directtrajopt_tpu.parallel.init_distributed(...)`` at program start, then
run this script unchanged — the mesh spans the global device set.

Prints one JSON line per device count plus a summary line, and appends the
records under ``"scaling"`` in ``bench_report.json``.
"""

import json
import os
import pathlib
import sys


def main():
    emulated = False
    if "--emulate" in sys.argv or os.environ.get("DTX_EMULATE_DEVICES"):
        n = int(os.environ.get("DTX_EMULATE_DEVICES", "8"))
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n}"
        )
        emulated = True

    import jax

    if emulated:
        jax.config.update("jax_platforms", "cpu")

    from directtrajopt_tpu.benchmarks import make_batched_bilinear_problems
    from directtrajopt_tpu.parallel import weak_scaling

    n_dev = len(jax.devices())
    if emulated:
        jax.config.update("jax_enable_x64", True)
    elif jax.devices()[0].platform != "gpu":
        sys.exit("bench_scaling.py needs GPUs (or --emulate for a CPU mesh)")
    if n_dev == 1:
        print(
            json.dumps(
                {
                    "metric": "weak_scaling_efficiency",
                    "value": 1.0,
                    "unit": "fraction",
                    "note": "single device — run with --emulate or on a slice",
                }
            )
        )
        return

    N = 21 if emulated else 51

    def make_batch(total):
        return make_batched_bilinear_problems(total, N=N, feasible_start=True)

    make_batch.per_device = 4 if emulated else 32

    records = weak_scaling(
        make_batch,
        tol=1e-8 if emulated else 1e-5,
        acceptable_tol=1e-6 if emulated else 5e-4,
        acceptable_iter=1,
        max_iter=40,
    )
    for r in records:
        r["emulated"] = emulated
        print(json.dumps({"metric": "weak_scaling", **r}), file=sys.stderr)

    eff = records[-1]["efficiency"]
    if emulated:
        # emulated devices share one socket: adding "devices" adds work on
        # the same silicon, so wall-clock efficiency is 1/n by construction
        # and NOT a hardware measurement. The meaningful emulated signal is
        # that the sharded program compiles, runs, and matches unsharded
        # results (tests/test_mpc_and_parallel.py) — report that.
        print(
            json.dumps(
                {
                    "metric": "weak_scaling_mechanism",
                    "value": 1.0,
                    "unit": "sharded solve validated on emulated mesh",
                    "devices": records[-1]["devices"],
                    "note": "run on a real slice for efficiency numbers",
                }
            )
        )
    else:
        print(
            json.dumps(
                {
                    "metric": "weak_scaling_efficiency",
                    "value": eff,
                    "unit": f"fraction at {records[-1]['devices']} devices",
                }
            )
        )

    # merge into the stable bench report schema
    path = pathlib.Path(__file__).parent / "bench_report.json"
    report = json.loads(path.read_text()) if path.exists() else {}
    report["scaling"] = records
    path.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
