"""QMRCGStab — quasi-minimal-residual smoothed BiCGStab.

Reference parity: QMRCGStab (src/solvers/krylov/qmrcgstab.{hpp,cpp}) — the
Chan/Gallopoulos/Simoncini/Szeto/Tong algorithm: BiCGStab's two half-steps
each followed by a QMR smoothing update. Right preconditioned.

Design: one `lax.while_loop`; both half-step convergence checks
run on-device with the true residual of the smoothed iterate tracked cheaply
via the quasi-residual tau (checked against ||r|| recurrence like the
reference).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..iter_ctrl import IterationControl, info_from_state
from ._common import guarded_check, prepare, safe_div


def qmrcgstab(A, b, x0=None, M=None, *,
              ctrl: IterationControl | None = None, **kwargs):
    """Solve A x = b with right-preconditioned QMRCGStab.

    Returns ``(x, SolverInfo)``.
    """
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype

    r = b - op(x)
    res0 = red.norm(r)
    state = ctrl.init_residual(jnp.abs(res0))
    r0 = r
    one = jnp.ones((), dtype)
    zero_v = jnp.zeros_like(r)
    p, v, d = zero_v, zero_v, zero_v
    rho, alpha, omega = one, one, one
    tau = res0.astype(rdtype)
    theta = jnp.zeros((), rdtype)
    eta = jnp.zeros((), dtype)

    def cond(carry):
        return carry[-1].running

    def body(carry):
        x, r, p, v, d, rho, alpha, omega, tau, theta, eta, state = carry
        rho_new = red.dot_nonconj(r0, r)
        beta = safe_div(rho_new * alpha, rho * omega)
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = op(phat)
        alpha = safe_div(rho_new, red.dot_nonconj(r0, v))
        s = r - alpha * v

        # first quasi-minimization half-step
        theta1 = safe_div(red.norm(s), tau)
        c1 = 1.0 / jnp.sqrt(1.0 + theta1 * theta1)
        tau1 = tau * theta1 * c1
        eta1 = c1 * c1 * alpha
        d1 = phat + safe_div(theta * theta * eta, alpha) * d
        x_half = x + eta1 * d1
        state = guarded_check(ctrl, state, jnp.abs(tau1))
        live = state.running

        # second half-step
        shat = precond(s)
        t = op(shat)
        omega_new = safe_div(red.dot_nonconj(t, s), red.dot_nonconj(t, t))
        r_new = s - omega_new * t
        theta2 = safe_div(red.norm(r_new), tau1)
        c2 = 1.0 / jnp.sqrt(1.0 + theta2 * theta2)
        tau2 = tau1 * theta2 * c2
        eta2 = c2 * c2 * omega_new
        d2 = shat + safe_div(theta1 * theta1 * eta1, omega_new) * d1
        x_full = x_half + eta2 * d2
        state = guarded_check(ctrl, state, jnp.abs(tau2))

        x = jnp.where(live, x_full, x_half)
        r = jnp.where(live, r_new, s)
        d = jnp.where(live, d2, d1)
        tau = jnp.where(live, tau2, tau1)
        theta = jnp.where(live, theta2, theta1)
        eta = jnp.where(live, eta2, eta1)
        omega = jnp.where(live, omega_new, omega)
        return (x, r, p, v, d, rho_new, alpha, omega, tau, theta, eta, state)

    carry = (x, r, p, v, d, rho, alpha, omega, tau, theta, eta, state)
    out = jax.lax.while_loop(cond, body, carry)
    return out[0], info_from_state(out[-1])
