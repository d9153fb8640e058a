"""The fused Riccati KKT sweeps (`ops/riccati_kernel.py`) in f32, batched,
against the same sweeps in f64.

The sweeps are the IPM's KKT solve (the analog of Ipopt's LBLᵀ hot loop,
upstream `src/solvers/evaluator.jl:389-404`); the batched solve runs
them vmapped in f32. They must match the f64 sweep to f32 round-off grown
over the knot recursion, entry for entry, including the multipliers and the
positive-definiteness certificate, and padded or odd batches must not
change any lane's result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from directtrajopt_tpu.ops import riccati_kernel as rk

NAMES = ["P", "Lv", "Kg", "Mvs", "L0", "ok", "dzs", "dzv", "lam"]


def _random_stage_data(seed, B=4, N=7, ns=5, nv=3, R=3, convex=True):
    rng = np.random.default_rng(seed)

    def sym(x):
        return 0.5 * (x + np.swapaxes(x, -1, -2))

    shift = 2.0 if convex else 0.3
    Qss = sym(rng.standard_normal((B, N, ns, ns))) * 0.1 + np.eye(ns) * shift
    Qsv = rng.standard_normal((B, N, ns, nv)) * 0.1
    Qvv = sym(rng.standard_normal((B, N, nv, nv))) * 0.1 + np.eye(nv) * shift
    A = rng.standard_normal((B, N, ns, ns)) * 0.3
    A[:, -1] = 0.0
    Bm = rng.standard_normal((B, N, ns, nv)) * 0.3
    Bm[:, -1] = 0.0
    qs = rng.standard_normal((B, R, N, ns))
    qv = rng.standard_normal((B, R, N, nv))
    b = rng.standard_normal((B, R, N, ns))
    b[:, :, -1] = 0.0
    return [jnp.asarray(x, jnp.float32) for x in (Qss, Qsv, Qvv, A, Bm, qs, qv, b)]


def _key(ns, pinned=()):
    return tuple(0 if i in pinned else 1 for i in range(ns))


def _f64(args):
    return [jnp.asarray(np.asarray(x), jnp.float64) for x in args]


def _assert_close(ref, out, rtol, names=NAMES):
    for name, x, p in zip(names, ref, out):
        x, p = np.asarray(x), np.asarray(p)
        assert x.shape == p.shape, name
        if x.dtype == bool:
            assert (x == p).all(), name
            continue
        scale = max(np.max(np.abs(x)), 1.0)
        assert np.max(np.abs(x - p)) / scale < rtol, name


@pytest.mark.parametrize("ns,nv,R", [(5, 3, 3), (8, 3, 1), (4, 2, 6)])
def test_factor_solve_matches_xla(ns, nv, R):
    """Batched f32 factor+solve against the f64 sweep."""
    key = _key(ns, pinned=(min(2, ns - 1),))
    args = _random_stage_data(0, ns=ns, nv=nv, R=R)
    fs = jax.vmap(rk.make_factor_solve(key))
    out = fs(*args)
    assert out[0].dtype == jnp.float32
    _assert_close(fs(*_f64(args)), out, 5e-6)


def test_resolve_matches_xla():
    """Batched f32 resolve against stored f32 factors, vs the f64 pair."""
    ns, nv, R = 5, 3, 1
    key = _key(ns)
    args = _random_stage_data(1, ns=ns, nv=nv, R=R)
    fs, rs = jax.vmap(rk.make_factor_solve(key)), jax.vmap(rk.make_resolve(key))

    def solve(a):
        fac = fs(*a)
        return rs(*fac[:5], *a[3:5], *a[5:])

    _assert_close(solve(_f64(args)), solve(args), 5e-6, ["dzs", "dzv", "lam"])


def test_nonconvex_certificate_agrees():
    """Indefinite stages: the f32 ok flag must match the f64 per-lane verdict."""
    key = _key(5)
    args = _random_stage_data(2, B=8, convex=False)
    fs = jax.vmap(rk.make_factor_solve(key))
    ok32, ok64 = np.asarray(fs(*args)[5]), np.asarray(fs(*_f64(args))[5])
    assert (ok32 == ok64).all()
    assert not ok64.all()  # fixture really is indefinite somewhere
    assert ok64.any()


def test_batch_padding():
    """Identity-padded lanes (as compacted chunks carry) leave every real
    lane's factorization and solution unchanged."""
    key = _key(5)
    args = _random_stage_data(3, B=5)
    pad = _random_stage_data(4, B=3)
    pad[2] = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), pad[2].shape)
    padded = [jnp.concatenate([a, p]) for a, p in zip(args, pad)]
    fs = jax.vmap(rk.make_factor_solve(key))
    ref = fs(*args)
    out = [x[:5] for x in fs(*padded)]
    _assert_close(ref, out, 1e-6)


def test_e2e_odd_batch_solve_matches_single():
    """A vmapped IPM solve over an odd batch equals each lane solved alone."""
    from directtrajopt_tpu.benchmarks import make_batched_bilinear_problems
    from directtrajopt_tpu.solvers.canonical import make_nlp
    from directtrajopt_tpu.solvers.ipm import ipm_solve
    from directtrajopt_tpu.solvers.ops_riccati import RiccatiOps
    from directtrajopt_tpu.solvers.options import IPMOptions

    batch = make_batched_bilinear_problems(3, N=7, feasible_start=True)
    opts = IPMOptions(max_iter=8, tol=1e-10)

    def one(problem):
        nlp = make_nlp(problem)
        return ipm_solve(nlp, problem.trajectory.to_zvec(), opts, ops=RiccatiOps(nlp)).Z

    Z_batch = np.asarray(jax.vmap(one)(batch))
    for i in range(3):
        lane = jax.tree.map(lambda x: x[i], batch)
        np.testing.assert_allclose(np.asarray(one(lane)), Z_batch[i], atol=1e-10)
