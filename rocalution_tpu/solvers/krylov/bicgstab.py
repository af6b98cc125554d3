"""Preconditioned BiCGStab.

Reference parity: BiCGStab (src/solvers/krylov/bicgstab.{hpp,cpp}) — van der
Vorst's stabilized bi-conjugate gradients with right preconditioning and the
half-step convergence check (the reference checks ||s|| before the second
matvec and exits early with the half update).

Design: one `lax.while_loop`; the half-step early exit is expressed as a
tree-select between the half and full updates (no host round trip), and
breakdown divisions are guarded so masked lanes never produce NaN.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..iter_ctrl import IterationControl, info_from_state
from ._common import prepare, safe_div, select_tree


def bicgstab(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None,
             **kwargs):
    """Solve A x = b with right-preconditioned BiCGStab.

    Returns ``(x, SolverInfo)``.
    """
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)

    r = b - op(x)
    state = ctrl.init_residual(jnp.abs(red.res_norm(r)))
    r0 = r                      # shadow residual
    p = jnp.zeros_like(r)
    v = jnp.zeros_like(r)
    one = jnp.ones((), r.dtype)
    rho, alpha, omega = one, one, one

    def cond(carry):
        return carry[-1].running

    def body(carry):
        x, r, r0, p, v, rho, alpha, omega, state = carry
        rho_new = red.dot_nonconj(r0, r)
        beta = safe_div(rho_new * alpha, rho * omega)
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = op(phat)
        alpha = safe_div(rho_new, red.dot_nonconj(r0, v))
        s = r - alpha * v
        # half-step check (reference: bicgstab.cpp checks ||s|| mid-iteration)
        state_half = ctrl.check_residual(state, jnp.abs(red.res_norm(s)))
        x_half = x + alpha * phat

        shat = precond(s)
        t = op(shat)
        omega_new = safe_div(red.dot_nonconj(t, s), red.dot_nonconj(t, t))
        x_full = x_half + omega_new * shat
        r_full = s - omega_new * t
        state_full = ctrl.check_residual(state, jnp.abs(red.res_norm(r_full)))

        go_full = state_half.running
        x = jnp.where(go_full, x_full, x_half)
        r = jnp.where(go_full, r_full, s)
        omega = jnp.where(go_full, omega_new, omega)
        state = select_tree(go_full, state_full, state_half)
        return (x, r, r0, p, v, rho_new, alpha, omega, state)

    carry = (x, r, r0, p, v, rho, alpha, omega, state)
    out = jax.lax.while_loop(cond, body, carry)
    return out[0], info_from_state(out[-1])
