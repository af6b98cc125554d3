"""Preconditioned Conjugate Residual.

Reference parity: CR (src/solvers/krylov/cr.{hpp,cpp}) — minimizes the
residual norm for symmetric (possibly indefinite) operators; same convergence
criteria/status semantics via IterationControl. Like every solver here it
serves Local and Global operators with one code path (pass ``axis_name=``
inside shard_map for the distributed instantiation, analog cr.cpp Global
template instantiation).

Design: one `lax.while_loop`, all reductions on-device; the
preconditioned CR recurrence keeps both z = M r and v = A p in the carry so
each iteration costs one SpMV + one preconditioner apply.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..iter_ctrl import IterationControl, info_from_state
from ._common import prepare, safe_div


def cr(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None, **kwargs):
    """Solve A x = b with (preconditioned) CR. Returns ``(x, SolverInfo)``."""
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)

    r = b - op(x)
    state = ctrl.init_residual(jnp.abs(red.res_norm(r)))

    z = precond(r)
    p = z
    w = op(z)           # A z
    v = w               # A p
    rho = red.dot_nonconj(z, w)

    def cond(carry):
        return carry[-1].running

    def body(carry):
        x, r, z, p, v, rho, state = carry
        t = precond(v)                       # M A p
        sigma = red.dot_nonconj(v, t)
        alpha = safe_div(rho, sigma)
        x = x + alpha * p
        r = r - alpha * v
        z = z - alpha * t
        state = ctrl.check_residual(state, jnp.abs(red.res_norm(r)))
        w = op(z)
        rho_new = red.dot_nonconj(z, w)
        beta = safe_div(rho_new, rho)
        p = z + beta * p
        v = w + beta * v
        return (x, r, z, p, v, rho_new, state)

    carry = (x, r, z, p, v, rho, state)
    x, r, z, p, v, rho, state = jax.lax.while_loop(cond, body, carry)
    return x, info_from_state(state)
