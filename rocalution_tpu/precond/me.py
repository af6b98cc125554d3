"""MultiElimination (ME-ILU), VariablePreconditioner, saddle-point
preconditioner.

Reference parity:
- MultiElimination (preconditioner_multielimination.{hpp,cpp}) — recursive
  2×2 block elimination: ZeroBlockPermutation puts a maximal independent set
  first so the leading block D is diagonal; recurse on the (dropped) Schur
  complement S = C - E D^{-1} F (``Set(AA_solver, level, drop_off)``,
  preconditioner_multielimination.hpp:87-98).
- VariablePreconditioner (preconditioner.hpp:431-445) — cycles among N
  sub-preconditioners per application.
- DiagJacobiSaddlePointPrecond (preconditioner_saddlepoint.hpp:38-59) —
  K = [A B; C 0] handled via the Jacobi-diagonal transform: block solves on
  A's diagonal and the diagonal-Jacobi Schur complement S = -C D_A^{-1} B.

Design: all permutations/Schur products are host-side setup (scipy
SpGEMM); applies are gather + SpMV + recursive closure chains — one XLA
program end to end.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import CSR, to_csr
from ..formats.base import get_host
from ..ops.extract import extract_submatrix
from ..ops.ordering import permute_csr, zero_block_permutation
from ..ops.spmv import spmv


def _scipy(A: CSR):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (get_host(A, "data"), get_host(A, "indices").astype(np.int64),
         get_host(A, "indptr").astype(np.int64)), shape=A.shape,
    )


def _from_scipy(S) -> CSR:
    S = S.tocoo()
    return CSR.from_coo(S.row, S.col, S.data, S.shape)


def _dense_inverse_solver(A: CSR) -> Callable:
    # host-side inverse (setup phase)
    inv = jnp.asarray(np.linalg.inv(_scipy(A).toarray()))
    return lambda r: jnp.matmul(inv, r, precision=jax.lax.Precision.HIGHEST)


def multi_elimination(A, levels: int = 2, drop_tol: float = 0.0,
                      last_solver: Optional[Callable] = None) -> Callable:
    """ME-ILU preconditioner closure (reference: MultiElimination
    Set(AA_solver, level, drop_off)).

    `last_solver(matrix) -> closure` builds the coarsest solver (default:
    dense inverse). `drop_tol` drops Schur entries below it (drop_off).
    """
    csr = A if isinstance(A, CSR) else to_csr(A)
    n = csr.shape[0]
    build_last = last_solver or _dense_inverse_solver
    if levels <= 0 or n <= 8:
        return build_last(csr)

    size, perm = zero_block_permutation(csr)
    if size == 0 or size == n:
        return build_last(csr)
    Ap = permute_csr(csr, perm)
    Sp = _scipy(Ap)

    import scipy.sparse as sp

    D = Sp[:size, :size]
    F = Sp[:size, size:]
    E = Sp[size:, :size]
    C = Sp[size:, size:]
    d = np.asarray(D.diagonal())
    if np.any(d == 0):
        return build_last(csr)
    inv_d = 1.0 / d
    S = (C - E @ sp.diags(inv_d) @ F).tocsr()
    if drop_tol > 0:
        diag = S.diagonal()
        S.data[np.abs(S.data) < drop_tol] = 0.0
        S.eliminate_zeros()
        S = (S + sp.diags(diag - S.diagonal())).tocsr()

    inner = multi_elimination(
        _from_scipy(S), levels - 1, drop_tol, last_solver
    )
    Fj = _from_scipy(F)
    Ej = _from_scipy(E)
    inv_dj = jnp.asarray(inv_d)
    order_j = jnp.asarray(np.argsort(perm))  # old index per new slot
    perm_j = jnp.asarray(perm)

    def apply(r):
        rp = r[order_j]
        r1, r2 = rp[:size], rp[size:]
        y2 = inner(r2 - spmv(Ej, inv_dj * r1))
        y1 = inv_dj * (r1 - spmv(Fj, y2))
        zp = jnp.concatenate([y1, y2])
        return zp[perm_j]

    return apply


def variable_precond(preconds: Sequence[Callable]) -> Callable:
    """VariablePreconditioner: cycles among sub-preconditioners per
    application (reference: preconditioner.hpp:431-445).

    Design: the cycle counter is an on-device array ref (`jax.new_ref`)
    mutated inside the traced apply, so the rotation advances per
    *application* even inside a `lax.while_loop` solver body — `lax.switch`
    selects the sub-preconditioner on device, matching the reference's
    per-call semantics exactly (not merely per trace site).
    """
    counter = jax.new_ref(jnp.zeros((), jnp.int32))
    branches = list(preconds)
    n = len(branches)

    def apply(r):
        k = counter[...]
        counter[...] = k + 1
        return jax.lax.switch(k % n, branches, r)

    return apply


def saddle_point_precond(K, m: int, solver_A: Optional[Callable] = None,
                         solver_S: Optional[Callable] = None) -> Callable:
    """Saddle-point preconditioner for K = [A B; C 0] with A the leading
    m×m block (reference: DiagJacobiSaddlePointPrecond — Jacobi-diagonal
    transform, inner solvers on A and S = -C D_A^{-1} B).

    `solver_A(A_csr) -> closure`, `solver_S(S_csr) -> closure` (defaults:
    dense inverses).
    """
    csr = K if isinstance(K, CSR) else to_csr(K)
    n = csr.shape[0]
    Sp = _scipy(csr)

    import scipy.sparse as sp

    A = Sp[:m, :m].tocsr()
    B = Sp[:m, m:].tocsr()
    C = Sp[m:, :m].tocsr()
    dA = np.asarray(A.diagonal())
    if np.any(dA == 0):
        raise ValueError("saddle-point A block has zero diagonal")
    S = (-C @ sp.diags(1.0 / dA) @ B).tocsr()

    mkA = solver_A or _dense_inverse_solver
    mkS = solver_S or _dense_inverse_solver
    solveA = mkA(_from_scipy(A))
    solveS = mkS(_from_scipy(S))
    Cj = _from_scipy(C)

    def apply(r):
        r1, r2 = r[:m], r[m:]
        z1 = solveA(r1)
        z2 = solveS(r2 - spmv(Cj, z1))
        return jnp.concatenate([z1, z2])

    return apply
