"""Flexible Conjugate Gradient.

Reference parity: FCG (src/solvers/krylov/fcg.{hpp,cpp}) — CG with the
Polak–Ribière (Notay) beta so the preconditioner may change between
iterations (e.g. an inner iterative solver as preconditioner). Convergence
semantics via IterationControl as everywhere.

Design: one `lax.while_loop`; the flexible beta costs one extra dot over
plain CG — both dots ride the same fused elementwise pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..iter_ctrl import IterationControl, info_from_state
from ._common import prepare, safe_div


def fcg(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None, **kwargs):
    """Solve A x = b with flexible CG. Returns ``(x, SolverInfo)``."""
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)

    r = b - op(x)
    state = ctrl.init_residual(jnp.abs(red.res_norm(r)))
    z = precond(r)
    p = z
    rho = red.dot_nonconj(r, z)

    def cond(carry):
        return carry[-1].running

    def body(carry):
        x, r, p, rho, state = carry
        q = op(p)
        alpha = safe_div(rho, red.dot_nonconj(p, q))
        x = x + alpha * p
        r_new = r - alpha * q
        state = ctrl.check_residual(state, jnp.abs(red.res_norm(r_new)))
        z = precond(r_new)
        rho_new = red.dot_nonconj(r_new, z)
        # Polak–Ribière / Notay flexible beta: <z_{k+1}, r_{k+1} - r_k> / rho
        beta = safe_div(rho_new - red.dot_nonconj(z, r), rho)
        p = z + beta * p
        return (x, r_new, p, rho_new, state)

    carry = (x, r, p, rho, state)
    x, r, p, rho, state = jax.lax.while_loop(cond, body, carry)
    return x, info_from_state(state)
