"""Gauss-Seidel / symmetric GS / SOR preconditioners.

Reference parity: GS, SGS (src/solvers/preconditioners/preconditioner.cpp —
Build extracts the triangular splits, apply = LSolve/LLSolve) plus the SOR
relaxation family. Applies are exact triangular solves.

Design: the split is host-side setup; each apply is a LevelSchedule
`lax.scan` (see ops/trisolve) — one compiled program, no host syncs.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..formats import CSR, to_csr
from ..ops.extract import extract_lower, extract_upper
from ..ops.trisolve import build_schedule, solve_schedule
from .jacobi import extract_diagonal


def gs(A) -> "callable":
    """Gauss-Seidel: z = (D + L)^{-1} r (reference: GS preconditioner)."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    sched = build_schedule(extract_lower(csr, diag=True))
    return lambda r: solve_schedule(sched, r)


def backward_gs(A) -> "callable":
    """Backward Gauss-Seidel: z = (D + U)^{-1} r."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    sched = build_schedule(extract_upper(csr, diag=True))
    return lambda r: solve_schedule(sched, r)


def sgs(A) -> "callable":
    """Symmetric Gauss-Seidel: z = (D+U)^{-1} D (D+L)^{-1} r (reference: SGS
    preconditioner, LLSolve path)."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    lo = build_schedule(extract_lower(csr, diag=True))
    up = build_schedule(extract_upper(csr, diag=True))
    d = extract_diagonal(csr)

    def apply(r):
        y = solve_schedule(lo, r)
        dy = d * y if r.ndim == 1 else d[:, None] * y
        return solve_schedule(up, dy)

    return apply


def sor(A, omega: float = 1.0) -> "callable":
    """SOR: z = (D/omega + L)^{-1} r."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    from ..ops.extract import scale_diagonal

    M = scale_diagonal(extract_lower(csr, diag=True), 1.0 / omega)
    sched = build_schedule(M)
    return lambda r: solve_schedule(sched, r)


def ssor(A, omega: float = 1.0) -> "callable":
    """Symmetric SOR: z = (D/w+U)^{-1} (D/w) (D/w+L)^{-1} r."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    from ..ops.extract import scale_diagonal

    lo = build_schedule(scale_diagonal(extract_lower(csr, diag=True),
                                       1.0 / omega))
    up = build_schedule(scale_diagonal(extract_upper(csr, diag=True),
                                       1.0 / omega))
    d = extract_diagonal(csr) / omega

    def apply(r):
        y = solve_schedule(lo, r)
        dy = d * y if r.ndim == 1 else d[:, None] * y
        return solve_schedule(up, dy)

    return apply
