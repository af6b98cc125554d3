"""IDR(s) — Induced Dimension Reduction with shadow space dimension s.

Reference parity: IDR (src/solvers/krylov/idr.{hpp,cpp}), ``SetShadowSpace``
and ``SetRandomSeed`` (idr.hpp:73-76). Implements the bi-orthogonalized
IDR(s) variant (van Gijzen & Sonneveld), preconditioned, with the omega
angle-correction (kappa = 0.7).

Design: the shadow space dimension s is static, so the inner
k-sweep unrolls at trace time; the shadow basis P is an (s, n) block
generated from a jax PRNG key and orthonormalized once at setup. All s
shadow inner products per step batch into one (s, n) @ (n,) product — a
single collective distributed, at `Precision.HIGHEST` (not TF32). Mid-cycle convergence freezes updates via the
live mask (guarded_check).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..iter_ctrl import IterationControl, info_from_state
from ._common import guarded_check, prepare, safe_div


def _mm(a, b):
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def idr(A, b, x0=None, M=None, *, ctrl: IterationControl | None = None,
        **kwargs):
    """Solve A x = b with preconditioned IDR(s).

    Kwargs: ``shadow_space`` = s (default 4), ``seed`` (default 0, analog
    SetRandomSeed). Returns ``(x, SolverInfo)``.
    """
    s = int(kwargs.pop("shadow_space", 4))
    seed = int(kwargs.pop("seed", 0))
    kappa = float(kwargs.pop("kappa", 0.7))
    op, b, x, precond, ctrl, red = prepare(A, b, x0, M, ctrl, kwargs)
    n = b.shape[0]
    dtype = b.dtype
    rdtype = jnp.zeros((), dtype).real.dtype

    r = b - op(x)
    state = ctrl.init_residual(jnp.abs(red.res_norm(r)))

    key = jax.random.PRNGKey(seed)
    P = jax.random.normal(key, (n, s), rdtype).astype(dtype)
    P, _ = jnp.linalg.qr(P)          # (n, s) orthonormal columns
    P = P.T                          # (s, n)

    G = jnp.zeros((s, n), dtype)
    U = jnp.zeros((s, n), dtype)
    Mm = jnp.eye(s, dtype=dtype)
    omega = jnp.ones((), dtype)

    def shadow_dots(v):
        return red.allreduce(_mm(P, v))  # (s,)

    def cond(carry):
        return carry[-1].running

    def body(carry):
        x, r, G, U, Mm, omega, state = carry
        f = shadow_dots(r)
        for k in range(s):
            live = state.running
            # solve lower-triangular Mm[k:, k:] c = f[k:]
            c = solve_triangular(Mm[k:, k:], f[k:], lower=True)
            v = r - _mm(c, G[k:])
            v = precond(v)
            u_new = _mm(c, U[k:]) + omega * v
            g_new = op(u_new)
            # bi-orthogonalize g_new against P[0..k-1] (sequential MGS-style,
            # each step needs the updated g_new)
            for i in range(k):
                ai = safe_div(red.dot_nonconj(P[i], g_new), Mm[i, i])
                g_new = g_new - ai * G[i]
                u_new = u_new - ai * U[i]
            U = U.at[k].set(jnp.where(live, u_new, U[k]))
            G = G.at[k].set(jnp.where(live, g_new, G[k]))
            mk = shadow_dots(G[k])
            Mm = Mm.at[k:, k].set(jnp.where(live, mk[k:], Mm[k:, k]))
            beta = safe_div(f[k], Mm[k, k])
            r = jnp.where(live, r - beta * G[k], r)
            x = jnp.where(live, x + beta * U[k], x)
            state = guarded_check(ctrl, state, jnp.abs(red.res_norm(r)))
            if k + 1 < s:
                f = jnp.where(live, f - beta * Mm[:, k], f)
                f = f.at[: k + 1].set(0.0)
        # enter the next Sonneveld space
        live = state.running
        v = precond(r)
        t = op(v)
        tt = red.dot_nonconj(t, t)
        tr = red.dot_nonconj(t, r)
        om = safe_div(tr, tt)
        # angle correction (van Gijzen): keep |cos| >= kappa
        nt = jnp.sqrt(jnp.abs(tt))
        nr = red.norm(r)
        rho = jnp.abs(safe_div(tr, nt * nr))
        om = jnp.where(rho < kappa, om * safe_div(jnp.asarray(kappa, rho.dtype), rho), om)
        omega = jnp.where(live, om, omega)
        x = jnp.where(live, x + omega * v, x)
        r = jnp.where(live, r - omega * t, r)
        state = guarded_check(ctrl, state, jnp.abs(red.res_norm(r)))
        return (x, r, G, U, Mm, omega, state)

    carry = (x, r, G, U, Mm, omega, state)
    x, r, G, U, Mm, omega, state = jax.lax.while_loop(cond, body, carry)
    return x, info_from_state(state)
