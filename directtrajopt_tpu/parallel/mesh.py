"""Multi-device scenario-batch sharding.

The reference's entire parallelism story is shared-memory threads inside one
process (upstream `src/solvers/evaluator.jl:332-359`). Here the
scaling axis is the scenario batch: a stacked problem pytree shards over a
1-D ``jax.sharding.Mesh`` with the batch axis laid out over devices, and the
whole vmapped IPM runs SPMD — XLA inserts the (minimal) collectives; each
scenario's solve is independent so communication rides only on data layout.
Works identically on the GPUs of one host, on several hosts, and on the
CPU-emulated meshes used in tests.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..problem import DirectTrajOptProblem
from ..solvers.options import IPMOptions
from ..solvers.solve import SolveResult, _merge_options

__all__ = [
    "make_mesh",
    "shard_batch",
    "solve_batch_sharded",
    "solve_batch_compact_sharded",
    "init_distributed",
    "weak_scaling",
]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs: Any,
) -> tuple[int, int]:
    """Initialize multi-host JAX (one process per host) and return
    ``(process_index, process_count)``.

    Thin entry over :func:`jax.distributed.initialize`: pass the
    coordinator address and the process layout. After
    this, :func:`jax.devices` shows the global device set and the sharded
    solve path (:func:`solve_batch_sharded`) works across hosts unchanged —
    the batch axis spans the global mesh, each host feeds its addressable
    shard, and the network only ever carries the (tiny) result gathers that the
    caller requests.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    return jax.process_index(), jax.process_count()


def make_mesh(devices=None, axis_name: str = "batch") -> Mesh:
    """1-D device mesh over the scenario-batch axis."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(batch: Any, mesh: Mesh, axis_name: str = "batch") -> Any:
    """Place a stacked problem pytree with its leading axis sharded over the
    mesh. Batch size must be divisible by the mesh size."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), batch)


def solve_batch_sharded(
    batch: DirectTrajOptProblem,
    options: IPMOptions | None = None,
    *,
    mesh: Mesh | None = None,
    axis_name: str = "batch",
    backend: str = "auto",
    **kwargs: Any,
) -> SolveResult:
    """Solve a sharded scenario batch SPMD over the mesh.

    The batch is placed with its leading axis over the mesh devices and the
    vmapped solve is jitted with matching output shardings — each device runs
    its shard's IPM iterations locally; no cross-device collectives are on
    the hot path.
    """
    from ..solvers.solve import _batched_solver

    options = _merge_options(options, kwargs)
    mesh = mesh or make_mesh(axis_name=axis_name)
    batch = shard_batch(batch, mesh, axis_name)
    return _batched_solver(backend)(batch, options, None)


def solve_batch_compact_sharded(
    batch: DirectTrajOptProblem,
    options: IPMOptions | None = None,
    *,
    mesh: Mesh | None = None,
    axis_name: str = "batch",
    phases: tuple = ((14, None), (12, 1e-3), (24, 1e-3), (64, 1e-3)),
    chunk: int = 128,
    backend: str = "auto",
    warm=None,
    carry_duals: bool = False,
    **kwargs: Any,
) -> "SolveResult":
    """Sharded multi-phase compacting solve: each device runs the full
    :func:`~directtrajopt_tpu.solvers.solve.solve_batch_compact` schedule on
    ITS shard via ``shard_map`` — compaction (argsort + chunk gathers) stays
    device-local, so the hot path has **zero cross-device collectives**,
    exactly like :func:`solve_batch_sharded`. The per-device batch must be a
    multiple of nothing in particular (chunks pad), but throughput is best
    at ≥ ``chunk`` lanes per device.

    ``warm``/``carry_duals`` mirror ``solve_batch_compact`` (r5): a batched
    WarmStart (sharded along the batch axis here) for phase 1, and per-lane
    best-KKT dual carry into later phases — together they make the
    certified-quality polish stage (bench.py ``run_headline``) runnable
    multi-chip with the same zero-collective property.
    """
    options = _merge_options(options, kwargs)
    mesh = mesh or make_mesh(axis_name=axis_name)
    batch = shard_batch(batch, mesh, axis_name)
    fn = _sharded_compact_runner(
        backend, tuple(phases), chunk, axis_name,
        tuple(mesh.devices.flat),
        carry_duals, warm is not None,
    )
    if warm is not None:
        warm = shard_batch(warm, mesh, axis_name)
        return fn(batch, options, warm)
    return fn(batch, options)


@functools.lru_cache(maxsize=None)
def _sharded_compact_runner(backend, phases, chunk, axis_name, devices,
                            carry_duals=False, has_warm=False):
    """Cached jitted shard_map program.

    Rebuilding the shard_map closure per call makes every invocation a fresh
    jit cache entry — measured as a full retrace+lower of the compact body
    on EACH solve (~13 s/call at N=31; the r4 process-scaling proxy caught
    it). Cache key = everything that changes the traced program.
    """
    from jax.sharding import PartitionSpec as P

    from ..solvers.solve import _compact_body

    mesh = Mesh(np.asarray(devices), (axis_name,))
    body = _compact_body(backend, phases, chunk, carry_duals)
    spec_b = P(axis_name)
    if has_warm:
        fn = jax.shard_map(
            lambda b, o, w: body(b, o, w),
            mesh=mesh,
            in_specs=(spec_b, P(), spec_b),
            out_specs=spec_b,
            check_vma=False,
        )
    else:
        fn = jax.shard_map(
            lambda b, o: body(b, o, None),
            mesh=mesh,
            in_specs=(spec_b, P()),
            out_specs=spec_b,
            # the compact body's scan carries mix device-varying values with
            # replicated zero-inits; the program is embarrassingly parallel,
            # so skip the varying-manual-axes check instead of sprinkling
            # pcasts
            check_vma=False,
        )
    return jax.jit(fn)


def weak_scaling(
    make_batch,
    device_counts=None,
    options: IPMOptions | None = None,
    *,
    repeats: int = 3,
    axis_name: str = "batch",
    **kwargs: Any,
) -> list[dict]:
    """Weak-scaling measurement: solves/s at 1, 2, 4, ... devices with a
    fixed per-device batch.

    ``make_batch(total_batch)`` must return a stacked problem pytree of that
    leading size. Returns one record per device count:
    ``{"devices", "batch", "wall_s", "converged", "solves_per_s",
    "efficiency"}`` with efficiency relative to the single-device rate.

    This is the green-field analog of the reference's (absent) multi-process
    scaling harness (SURVEY §2.8): on an emulated CPU mesh the numbers
    validate the mechanism, on real devices they measure the sharding overhead —
    which for the scenario-batch axis is data layout only, so efficiency
    should sit near 1.0.
    """
    import time

    options = _merge_options(options, kwargs)
    all_devices = jax.devices()
    if device_counts is None:
        device_counts = [
            n for n in (1, 2, 4, 8, 16, 32) if n <= len(all_devices)
        ]
    records = []
    base_rate = None
    for n_dev in device_counts:
        mesh = make_mesh(all_devices[:n_dev], axis_name)
        batch = make_batch(n_dev * _per_device_hint(make_batch))
        res = solve_batch_sharded(batch, options, mesh=mesh, axis_name=axis_name)
        res.kkt_error.block_until_ready()  # compile + warm
        walls = []
        for _ in range(repeats):
            t0 = time.time()
            res = solve_batch_sharded(
                batch, options, mesh=mesh, axis_name=axis_name
            )
            res.kkt_error.block_until_ready()
            walls.append(time.time() - t0)
        wall = float(np.median(walls))
        conv = int(np.asarray(res.converged).sum())
        B = int(np.asarray(res.converged).shape[0])
        # efficiency is measured in processed lanes/s: every lane runs the
        # same lockstep program, while per-lane convergence depends on the
        # sampled problem and would add noise unrelated to scaling
        rate = B / wall
        if base_rate is None:
            base_rate = rate / n_dev or 1.0
        records.append(
            {
                "devices": int(n_dev),
                "batch": B,
                "wall_s": round(wall, 4),
                "converged": conv,
                "lanes_per_s": round(rate, 2),
                "solves_per_s": round(conv / wall, 2),
                "efficiency": round(rate / (base_rate * n_dev), 3),
            }
        )
    return records


def _per_device_hint(make_batch) -> int:
    return int(getattr(make_batch, "per_device", 8))
