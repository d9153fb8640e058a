"""Quality gate for the headline benchmark configuration.

The headline pipeline (``directtrajopt_tpu.benchmarks.headline_config``:
GN seek at 1e-6 + exact-Hessian compensated-f32 polish at 1e-7, Taylor
order 6, compacted chunks, trimmed trial grid) must produce control
sequences within RMS < 1e-4 of the independent scipy trust-constr golden
optimum (``tests/golden/bilinear_n51_seed42.npz``), the reference's
cross-solver agreement bar
(`/root/reference/test/solver_test_utils.jl:105-132`, BASELINE #1).
``bench.py`` and ``chip_smoke.py`` import the same configuration, so the
kwargs cannot drift.

Every lane of the batched benchmark poses the same optimization problem
from a different start (per-lane data is the initial guess; bounds, pins
and objective are shared), so one certified optimum covers all lanes.
"""

import inspect
import os

import numpy as np
import pytest

from directtrajopt_tpu.benchmarks import (
    headline_config,
    make_headline_batch,
    rms_u_vs_golden,
    run_headline,
)


@pytest.mark.slow
def test_headline_config_matches_golden():
    # the headline pipeline in f32 on a modest batch
    cfg = headline_config(batch=8)
    res, res_seek = run_headline(make_headline_batch(cfg), cfg)
    conv = np.asarray(res.converged)
    assert conv.all(), (conv, np.asarray(res.kkt_error))
    # the certificate the headline counts: kkt at or below the polish tol
    assert float(np.asarray(res.kkt_error).max()) <= 1e-6

    rms = rms_u_vs_golden(res)
    assert rms < 1e-4, f"headline-config solution quality: max RMS(u) {rms:.2e}"


@pytest.mark.gpu
def test_headline_config_on_gpu(gpu):
    """The headline pipeline on the card in f32, one compacted chunk."""
    cfg = headline_config(batch=256)
    res, _ = run_headline(make_headline_batch(cfg), cfg)
    conv = np.asarray(res.converged)
    assert conv.mean() >= 0.99
    assert float(np.asarray(res.kkt_error)[conv].max()) <= 1e-6
    assert rms_u_vs_golden(res, n_lanes=64) < 1e-4


def test_golden_certificate_present():
    """The fixture the gate relies on exists and carries its certificate."""
    path = os.path.join(
        os.path.dirname(__file__), "golden", "bilinear_n51_seed42.npz"
    )
    data = np.load(path)
    assert float(data["feas"]) <= 1e-8
    assert float(data["stat"]) <= 1e-6


def test_headline_config_kwargs_accepted():
    """Every kwarg of both stages is a ``solve_batch_compact`` parameter or
    an ``IPMOptions`` field (unknown solver options are only warned about
    and dropped), and the batch has the configured shape and dtype."""
    import jax.numpy as jnp

    from directtrajopt_tpu.solvers.options import IPMOptions
    from directtrajopt_tpu.solvers.solve import solve_batch_compact

    cfg = headline_config(batch=4)
    assert cfg["batch"] == 4 and cfg["N"] == 51
    params = set(inspect.signature(solve_batch_compact).parameters)
    fields = set(IPMOptions.__dataclass_fields__)
    for stage in ("phase1_kw", "polish_kw"):
        kw = cfg[stage]
        unknown = [k for k in kw if k not in params and k not in fields]
        assert not unknown, (stage, unknown)
        assert kw["chunk"] == 4
    batch = make_headline_batch(cfg)
    u = batch.trajectory.data["u"]
    assert u.shape == (4, 51, 2) and u.dtype == jnp.float32
    assert headline_config()["batch"] == 8192
