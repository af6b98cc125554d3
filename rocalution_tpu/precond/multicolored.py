"""Multi-colored preconditioners.

Reference parity: MultiColored base → MultiColoredGS / MultiColoredSGS
(preconditioner_multicolored.cpp, _gs.cpp) and MultiColoredILU with the
power(q)-pattern ``Set(p, q)`` (preconditioner_multicolored_ilu.hpp:75) —
color-reorder the matrix so triangular sweeps become per-color parallel
blocks.

Design: coloring runs host-side (Jones–Plassmann, ops/ordering); the
permuted triangular factors feed the same LevelSchedule machinery as plain
GS/ILU — Kahn layering on a color-permuted matrix produces ≤ num_colors
levels (each a full-width batch), which is exactly the reference's
"per-color sweeps become batched ops" design, with the permutation applied
as device gathers around the scan.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..formats import CSR, to_csr
from ..ops.factorize import ilu0, ilup
from ..ops.ordering import multicoloring, permute_csr
from ..ops.trisolve import build_schedule, solve_schedule
from .gs import gs as _gs, sgs as _sgs
from .jacobi import extract_diagonal


def _power_pattern(A: CSR, q: int) -> CSR:
    """Sparsity pattern of |A|^q carrying A's values on the original entries
    (reference: LocalMatrix::SymbolicPower feeding ILU(p,q))."""
    if q <= 1:
        return A
    import scipy.sparse as sp

    from ..formats.base import get_host

    data = get_host(A, "data")
    cols = get_host(A, "indices").astype(np.int64)
    indptr = get_host(A, "indptr").astype(np.int64)
    S = sp.csr_matrix(
        (np.ones(len(cols)), cols, indptr), shape=A.shape
    )
    P = S.copy()
    for _ in range(q - 1):
        P = (P @ S).tocsr()
        P.data[:] = 1.0
    Av = sp.csr_matrix((data, cols, indptr), shape=A.shape)
    # pattern of P (kept as explicit zeros) carrying A's values
    out = sp.csr_matrix(
        (np.zeros(P.nnz, dtype=data.dtype), P.indices, P.indptr),
        shape=A.shape,
    )
    out = (out + Av).tocsr()
    out.sum_duplicates()
    rows = np.repeat(np.arange(A.shape[0]), np.diff(out.indptr))
    return CSR.from_coo(rows, out.indices, out.data, A.shape)


def _permuted(A, perm):
    order = np.argsort(perm)            # old index per new slot
    perm_j = jnp.asarray(perm)
    order_j = jnp.asarray(order)
    return perm_j, order_j


def multicolored_gs(A):
    """MultiColoredGS: color-permute, then forward GS on the permuted matrix
    (colors collapse the level count to num_colors)."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    _, perm, _ = multicoloring(csr)
    Ap = permute_csr(csr, perm)
    _, order_j = _permuted(csr, perm)
    perm_j = jnp.asarray(perm)
    inner = _gs(Ap)

    def apply(r):
        z = inner(r[order_j])
        return z[perm_j]

    return apply


def multicolored_sgs(A):
    """MultiColoredSGS (reference: preconditioner_multicolored_gs.cpp)."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    _, perm, _ = multicoloring(csr)
    Ap = permute_csr(csr, perm)
    perm_j = jnp.asarray(perm)
    order_j = jnp.asarray(np.argsort(perm))
    inner = _sgs(Ap)

    def apply(r):
        z = inner(r[order_j])
        return z[perm_j]

    return apply


def multicolored_ilu(A, p: int = 0, q: int | None = None):
    """MultiColoredILU(p, q): color by the |A|^q pattern, permute, ILU(p)
    factorize, level-scheduled solves (reference:
    preconditioner_multicolored_ilu.hpp Set(p, q, level))."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    if q is None:
        q = p + 1
    pattern = _power_pattern(csr, max(q, 1))
    _, perm, _ = multicoloring(pattern)
    Ap = permute_csr(csr, perm)
    L, U = ilu0(Ap) if p == 0 else ilup(Ap, p)
    ls = build_schedule(L, unit_diag=True)
    us = build_schedule(U)
    perm_j = jnp.asarray(perm)
    order_j = jnp.asarray(np.argsort(perm))

    def apply(r):
        z = solve_schedule(us, solve_schedule(ls, r[order_j]))
        return z[perm_j]

    return apply
