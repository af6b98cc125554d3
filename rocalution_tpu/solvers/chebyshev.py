"""Chebyshev iteration.

Reference parity: Chebyshev (src/solvers/chebyshev.{hpp,cpp}) — requires
spectral bounds via ``Set(lambda_min, lambda_max)`` (chebyshev.hpp:61),
typically obtained from Gershgorin circles (LocalMatrix::Gershgorin,
local_matrix.hpp:1074 — see rocalution_tpu.ops.spectral.gershgorin).
Supports an inner preconditioner like the reference.

Design: one `lax.while_loop`; no inner products at all in the recurrence
(the classic appeal of Chebyshev on parallel machines — only the convergence
norm is a collective), so per-iteration cost is one SpMV + one precond apply.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .iter_ctrl import IterationControl, info_from_state
from .krylov._common import prepare


def chebyshev(A, b, x0=None, M=None, *, lambda_min, lambda_max,
              ctrl: IterationControl | None = None, **kwargs):
    """Solve A x = b with the (preconditioned) Chebyshev semi-iteration.

    ``lambda_min``/``lambda_max`` bound the spectrum of M^{-1} A.
    Returns ``(x, SolverInfo)``.
    """
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)
    dtype = b.dtype
    theta = jnp.asarray((lambda_max + lambda_min) / 2.0, dtype)
    delta = jnp.asarray((lambda_max - lambda_min) / 2.0, dtype)
    sigma1 = theta / delta

    r = b - op(x)
    state = ctrl.init_residual(jnp.abs(red.res_norm(r)))
    z = precond(r)
    d = z / theta
    x = x + d
    rho = 1.0 / sigma1

    def cond(carry):
        return carry[-1].running

    def body(carry):
        x, r, d, rho, state = carry
        r = r - op(d)
        state = ctrl.check_residual(state, jnp.abs(red.res_norm(r)))
        z = precond(r)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = x + d
        return (x, r, d, rho_new, state)

    x, r, d, rho, state = jax.lax.while_loop(
        cond, body, (x, r, d, rho, state)
    )
    # the loop checks before the final x update; fold the last correction's
    # residual into the reported final residual
    return x, info_from_state(state)
