"""Restarted GMRES and flexible GMRES.

Reference parity: GMRES (src/solvers/krylov/gmres.{hpp,cpp}) and FGMRES
(fgmres.{hpp,cpp}) — restarted Arnoldi with Givens rotations, default basis
size 30 (gmres.hpp:46,74), right preconditioning so the rotation-recurrence
residual estimate equals the true residual norm. FGMRES stores the
preconditioned basis Z so the preconditioner may change every iteration
(fgmres.hpp:48,75).

Design: outer restarts are a `lax.while_loop`; each Arnoldi step
orthogonalizes with classical Gram-Schmidt applied twice (CGS2) — two batched
(m+1, n) @ (n,) products instead of j sequential dots, i.e. two collectives
per iteration distributed, numerically equivalent to MGS. The Hessenberg
triangularization (Givens) lives in small static (m,) carries; the
least-squares solve pads unprocessed columns with identity so one static
`solve_triangular` handles every early-exit length. The basis products ask
for `Precision.HIGHEST`: in TF32 (a GPU's default for f32 products) the
CGS2 projections lose orthogonality and the iteration count grows.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..iter_ctrl import IterationControl, info_from_state
from ._common import prepare, safe_div


def _mm(a, b):
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _givens(a, b):
    """Complex-safe Givens rotation: returns (c, s, r) with c real so that
    [c, s; -conj(s), c] @ [a, b] = [r, 0]."""
    t = jnp.sqrt(jnp.abs(a) ** 2 + jnp.abs(b) ** 2)
    safe_t = jnp.where(t == 0, 1.0, t)
    abs_a = jnp.abs(a)
    phase = jnp.where(abs_a == 0, jnp.ones_like(a), a / jnp.where(abs_a == 0, 1.0, abs_a))
    c = jnp.where(t == 0, jnp.ones_like(abs_a), abs_a / safe_t)
    s = jnp.where(
        t == 0,
        jnp.zeros_like(a),
        jnp.where(abs_a == 0, jnp.ones_like(a), phase * jnp.conj(b) / safe_t),
    )
    r = phase * t
    return c, s, r


def _gmres_core(A, b, x0, M, ctrl, kwargs, *, flexible: bool):
    basis = int(kwargs.pop("basis_size", 30))
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)
    m = basis
    n = b.shape[0]
    dtype = b.dtype

    r = b - op(x)
    state = ctrl.init_residual(jnp.abs(red.norm(r)))

    def inner_step(carry):
        j, V, Z, R, cs, sn, g, state = carry
        vj = V[j]
        zj = precond(vj)
        if flexible:
            Z = Z.at[j].set(zj)
        w = op(zj)
        # CGS2 orthogonalization against V[0..j]
        mask = (jnp.arange(m + 1) <= j).astype(w.dtype)
        h1 = red.allreduce(_mm(jnp.conj(V), w)) * mask
        w = w - _mm(h1, V)
        h2 = red.allreduce(_mm(jnp.conj(V), w)) * mask
        w = w - _mm(h2, V)
        h = h1 + h2
        hj1 = red.norm(w)
        V = V.at[j + 1].set(w / jnp.where(hj1 == 0, 1.0, hj1))
        h = h.at[j + 1].set(hj1.astype(dtype))

        # apply stored rotations 0..j-1 (identity beyond — cs init 1, sn init 0)
        def rot(i, hcol):
            hi, hi1 = hcol[i], hcol[i + 1]
            hcol = hcol.at[i].set(cs[i] * hi + sn[i] * hi1)
            return hcol.at[i + 1].set(-jnp.conj(sn[i]) * hi + cs[i] * hi1)

        h = jax.lax.fori_loop(0, j, rot, h)
        c, s, rr = _givens(h[j], h[j + 1])
        cs = cs.at[j].set(c.astype(cs.dtype))
        sn = sn.at[j].set(s)
        h = h.at[j].set(rr).at[j + 1].set(0.0)
        gj = g[j]
        g = g.at[j].set(c * gj).at[j + 1].set(-jnp.conj(s) * gj)
        R = R.at[:, j].set(h[:m])
        state = ctrl.check_residual(state, jnp.abs(g[j + 1]))
        return (j + 1, V, Z, R, cs, sn, g, state)

    def inner_cond(carry):
        j, state = carry[0], carry[-1]
        return state.running & (j < m)

    def outer_body(carry):
        x, state = carry
        r = b - op(x)
        beta = red.norm(r)
        V = jnp.zeros((m + 1, n), dtype)
        V = V.at[0].set(r / jnp.where(beta == 0, 1.0, beta))
        Z = jnp.zeros((m if flexible else 1, n), dtype)
        R = jnp.eye(m, dtype=dtype)
        cs = jnp.ones((m,), jnp.zeros((), dtype).real.dtype)
        sn = jnp.zeros((m,), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta.astype(dtype))
        carry_in = (0, V, Z, R, cs, sn, g, state)
        j, V, Z, R, cs, sn, g, state = jax.lax.while_loop(
            inner_cond, inner_step, carry_in
        )
        g_solve = jnp.where(jnp.arange(m) < j, g[:m], 0.0)
        y = solve_triangular(R, g_solve, lower=False)
        if flexible:
            dx = _mm(y, Z)
        else:
            dx = precond(_mm(y, V[:m]))
        return (x + dx, state)

    def outer_cond(carry):
        return carry[-1].running

    x, state = jax.lax.while_loop(outer_cond, outer_body, (x, state))
    return x, info_from_state(state)


def gmres(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None,
          **kwargs):
    """Solve A x = b with restarted right-preconditioned GMRES(m).

    ``basis_size`` kwarg sets the restart length m (default 30, matching the
    reference gmres.hpp:46). Returns ``(x, SolverInfo)``.
    """
    return _gmres_core(A, b, x0, M, ctrl, kwargs, flexible=False)


def fgmres(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None,
           **kwargs):
    """Solve A x = b with flexible restarted GMRES(m) — the preconditioner may
    itself be an (iterative) solver changing every application."""
    return _gmres_core(A, b, x0, M, ctrl, kwargs, flexible=True)
