"""Fixed-point (preconditioned Richardson) iteration.

Reference parity: FixedPoint (src/solvers/solver.hpp:467-510, solver.cpp) —
x_{k+1} = x_k + omega * M^{-1} r_k with ``SetRelaxation(omega)``. With
M = Jacobi this is weighted Jacobi; with M = (SGS/ILU/...) it is the
corresponding stationary scheme. This is also the default AMG smoother
(base_amg.cpp BuildSmoothers).

Design: one `lax.while_loop`; also exposes `fixed_point_sweeps`, the
fixed-iteration-count no-convergence-check variant used as a multigrid
smoother (no norms → no collectives → fully fused by XLA).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .iter_ctrl import IterationControl, info_from_state
from .krylov._common import prepare


def fixed_point(A, b, x0=None, M=None, *, omega: float = 1.0,
                ctrl: IterationControl | None = None, **kwargs):
    """Solve A x = b with relaxed fixed-point iteration. Returns
    ``(x, SolverInfo)``."""
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)
    om = jnp.asarray(omega, b.dtype)

    r = b - op(x)
    state = ctrl.init_residual(jnp.abs(red.res_norm(r)))

    def cond(carry):
        return carry[-1].running

    def body(carry):
        x, r, state = carry
        x = x + om * precond(r)
        r = b - op(x)
        state = ctrl.check_residual(state, jnp.abs(red.res_norm(r)))
        return (x, r, state)

    x, r, state = jax.lax.while_loop(cond, body, (x, r, state))
    return x, info_from_state(state)


def fixed_point_sweeps(A, b, x, M=None, *, sweeps: int = 1,
                       omega: float = 1.0):
    """`sweeps` relaxation steps with NO convergence check — the smoother
    building block (reference: FixedPoint used as default smoother,
    base_amg.cpp). Returns x only."""
    from ..ops.spmv import as_operator

    op = as_operator(A)
    precond = (lambda r: r) if M is None else as_operator(M)
    om = jnp.asarray(omega, b.dtype)

    def body(_, x):
        return x + om * precond(b - op(x))

    return jax.lax.fori_loop(0, sweeps, body, x)
