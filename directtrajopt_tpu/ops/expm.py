"""Fixed-structure matrix exponential for small dense systems.

The reference computes dynamics residuals through a Krylov matrix-exponential
action (`expv` from ExponentialAction.jl,
/root/reference/src/integrators/bilinear_integrator.jl:81) and differentiates
it with ForwardDiff. The state dimensions of interest are small (4–64),
so a dense scaling-and-squaring Padé approximant with a *static* number of
squarings is both faster and XLA-friendly: no data-dependent control flow, a
fixed chain of small matmuls that vmaps over knots and scenario batches, and
exact forward/reverse AD through the whole chain (no custom Fréchet-derivative
code needed).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["expm_pade", "expm_apply"]

# Padé-13 numerator coefficients (standard Higham 2005 values).
_B13 = (
    64764752532480000.0,
    32382376266240000.0,
    7771770303897600.0,
    1187353796428800.0,
    129060195264000.0,
    10559470521600.0,
    670442572800.0,
    33522128640.0,
    1323241920.0,
    40840800.0,
    960960.0,
    16380.0,
    182.0,
    1.0,
)


def expm_pade(A: jax.Array, squarings: int = 4) -> jax.Array:
    """exp(A) via Padé-13 with a fixed number of scaling squarings.

    ``squarings`` is static: the result is exact to working precision whenever
    ``norm(A) / 2**squarings ≲ 5`` (the Padé-13 accuracy radius), which the
    default 8 satisfies for any sane ``Δt·G``. All ops are small dense matmuls
    so the whole thing fuses and batches.
    """
    dtype = A.dtype
    scale = jnp.asarray(2.0**-squarings, dtype)
    A = A * scale

    eye = jnp.eye(A.shape[-1], dtype=dtype)
    b = _B13
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A4 @ A2
    U = A @ (
        A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
        + b[7] * A6
        + b[5] * A4
        + b[3] * A2
        + b[1] * eye
    )
    V = (
        A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
        + b[6] * A6
        + b[4] * A4
        + b[2] * A2
        + b[0] * eye
    )
    # r = (V - U)^{-1} (V + U)
    R = jnp.linalg.solve(V - U, V + U)
    for _ in range(squarings):
        R = R @ R
    return R


def expm_apply(A: jax.Array, x: jax.Array, squarings: int = 4) -> jax.Array:
    """Action ``exp(A) @ x`` (the reference's ``expv(1, A, x)``)."""
    return expm_pade(A, squarings=squarings) @ x


def expv_taylor(A: jax.Array, x: jax.Array, order: int = 12) -> jax.Array:
    """Action ``exp(A) @ x`` by Taylor series — matvecs only, the cheapest
    form for small-norm systems (‖A‖ ≲ 1): ``order`` matvecs, no matmats,
    no LU. This is the hot-path form for bilinear quantum dynamics where
    ‖Δt·G‖ ~ 0.1."""
    y = x
    for k in range(order, 0, -1):
        y = x + (A @ y) / k
    return y
