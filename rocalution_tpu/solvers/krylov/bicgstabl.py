"""BiCGStab(l) — stabilized bi-conjugate gradients with degree-l minimal
residual polynomial.

Reference parity: BiCGStabl (src/solvers/krylov/bicgstabl.{hpp,cpp}),
``SetOrder(l)`` (bicgstabl.hpp:69, default 2). Right preconditioned: the
recurrences run on the transformed system (A M) z = r0, x = x0 + M z, so the
tracked residual is the true residual.

Design: the order l is static, so the BiCG and MR sweeps unroll at
trace time into straight-line vector code; the (l+1) direction/residual
vectors live in stacked (l+1, n) carries. Convergence may hit at any of the
l+1 checks per cycle — updates are masked by the live flag (guarded_check)
instead of breaking the loop, keeping everything a single `lax.while_loop`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..iter_ctrl import IterationControl, info_from_state
from ._common import guarded_check, prepare, safe_div


def bicgstabl(A, b, x0=None, M=None, *,
              ctrl: IterationControl | None = None, **kwargs):
    """Solve A x = b with right-preconditioned BiCGStab(l).

    ``order`` kwarg = l (default 2, matching the reference). Returns
    ``(x, SolverInfo)``.
    """
    order = int(kwargs.pop("order", 2))
    op, b, x0v, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)
    l = order
    dtype = b.dtype

    def K(v):  # transformed operator
        return op(precond(v))

    r0 = b - op(x0v)
    state = ctrl.init_residual(jnp.abs(red.res_norm(r0)))
    rhat = r0  # shadow residual
    n = b.shape[0]

    z = jnp.zeros_like(b)                 # solution in transformed space
    R = jnp.zeros((l + 1, n), dtype).at[0].set(r0)
    U = jnp.zeros((l + 1, n), dtype)
    one = jnp.ones((), dtype)
    rho0, alpha, omega = one, jnp.zeros((), dtype), one

    def cond(carry):
        return carry[-1].running

    def body(carry):
        z, R, U, rho0, alpha, omega, state = carry
        rho0 = -omega * rho0

        # --- BiCG part (unrolled, static l) ---
        for j in range(l):
            live = state.running
            rho1 = red.dot_nonconj(rhat, R[j])
            beta = safe_div(alpha * rho1, rho0)
            rho0 = jnp.where(live, rho1, rho0)
            for i in range(j + 1):
                U = U.at[i].set(jnp.where(live, R[i] - beta * U[i], U[i]))
            U = U.at[j + 1].set(jnp.where(live, K(U[j]), U[j + 1]))
            gamma = red.dot_nonconj(rhat, U[j + 1])
            alpha_new = safe_div(rho0, gamma)
            alpha = jnp.where(live, alpha_new, alpha)
            for i in range(j + 1):
                R = R.at[i].set(jnp.where(live, R[i] - alpha * U[i + 1], R[i]))
            R = R.at[j + 1].set(jnp.where(live, K(R[j]), R[j + 1]))
            z = jnp.where(live, z + alpha * U[0], z)
            state = guarded_check(ctrl, state, jnp.abs(red.res_norm(R[0])))

        # --- MR part: minimize ||R[0]|| over span{R[1..l]} (MGS) ---
        live = state.running
        tau = [[jnp.zeros((), dtype) for _ in range(l + 1)] for _ in range(l + 1)]
        sigma = [jnp.zeros((), dtype) for _ in range(l + 1)]
        gamma_p = [jnp.zeros((), dtype) for _ in range(l + 1)]
        for j in range(1, l + 1):
            for i in range(1, j):
                tau[i][j] = safe_div(red.dot_nonconj(R[i], R[j]), sigma[i])
                R = R.at[j].set(jnp.where(live, R[j] - tau[i][j] * R[i], R[j]))
            sigma[j] = red.dot_nonconj(R[j], R[j])
            gamma_p[j] = safe_div(red.dot_nonconj(R[0], R[j]), sigma[j])

        gamma = [jnp.zeros((), dtype) for _ in range(l + 1)]
        gamma[l] = gamma_p[l]
        for j in range(l - 1, 0, -1):
            acc = gamma_p[j]
            for i in range(j + 1, l + 1):
                acc = acc - tau[j][i] * gamma[i]
            gamma[j] = acc
        gamma_pp = [jnp.zeros((), dtype) for _ in range(l + 1)]
        for j in range(1, l):
            acc = gamma[j + 1]
            for i in range(j + 1, l):
                acc = acc + tau[j][i] * gamma[i + 1]
            gamma_pp[j] = acc

        omega = jnp.where(live, gamma[l], omega)
        z = jnp.where(live, z + gamma[1] * R[0], z)
        R = R.at[0].set(jnp.where(live, R[0] - gamma_p[l] * R[l], R[0]))
        U = U.at[0].set(jnp.where(live, U[0] - gamma[l] * U[l], U[0]))
        for j in range(1, l):
            U = U.at[0].set(jnp.where(live, U[0] - gamma[j] * U[j], U[0]))
            z = jnp.where(live, z + gamma_pp[j] * R[j], z)
            R = R.at[0].set(jnp.where(live, R[0] - gamma_p[j] * R[j], R[0]))
        state = guarded_check(ctrl, state, jnp.abs(red.res_norm(R[0])))
        return (z, R, U, rho0, alpha, omega, state)

    carry = (z, R, U, rho0, alpha, omega, state)
    z, R, U, rho0, alpha, omega, state = jax.lax.while_loop(cond, body, carry)
    return x0v + precond(z), info_from_state(state)
