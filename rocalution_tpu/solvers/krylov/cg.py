"""Preconditioned Conjugate Gradient.

Reference parity: CG::SolveNonPrecond_/SolvePrecond_
(src/solvers/krylov/cg.cpp:290-446) — same update order, same residual
definition (|b - A x_k|_2 checked after the x/r update), same use of the
non-conjugated dot for rho, so residual histories match iterate-for-iterate.

Design: the whole solve is one `lax.while_loop` whose carry holds
{x, r, z, p, rho, IterState}; convergence control runs on-device (no per-
iteration host sync, unlike the reference's Norm_ round trip). Works for any
operator/preconditioner callable — preconditioners may themselves be solvers
(preserving rocALUTION's "any solver preconditions any solver" property,
README.md:76-80).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ...ops import blas1
from ..iter_ctrl import IterationControl, info_from_state
from ._common import prepare


def cg(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None, **kwargs):
    """Solve A x = b with (preconditioned) CG.

    Returns ``(x, SolverInfo)``. Tolerance kwargs: abs_tol, rel_tol, div_tol,
    min_iter, max_iter, record_history (see IterationControl);
    ``res_norm=1|2|3`` selects the L1/L2/L-infinity convergence norm
    (SetResidualNorm analog — every solver accepts it). Pass
    ``axis_name=...`` when calling inside `shard_map` for a distributed solve.
    """
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
        alpha = rho / red.dot_nonconj(p, q)
        x = x + alpha * p
        r = r - alpha * q
        state = ctrl.check_residual(state, jnp.abs(red.res_norm(r)))
        z = precond(r)
        rho_new = red.dot_nonconj(r, z)
        beta = rho_new / rho
        p = z + beta * p
        return (x, r, p, rho_new, state)

    x, r, p, rho, state = jax.lax.while_loop(cond, body, (x, r, p, rho, state))
    return x, info_from_state(state)
