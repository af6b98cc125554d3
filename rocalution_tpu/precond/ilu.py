"""ILU / IC preconditioners.

Reference parity: ILU(p) / IC / ILUT / ItILU0 preconditioners
(src/solvers/preconditioners/preconditioner.cpp, alg enum
preconditioner.hpp:250-273): Build runs the factorization via LocalMatrix
ops, apply runs LUSolve / LLSolve.

Design: factorization is host-side setup (ops/factorize); the apply is
either exact level-scheduled scans (`method="levels"`, analog
TriSolverAlg_Default) or fixed Jacobi sweeps on the factors
(`method="jacobi"`, analog TriSolverAlg_Iterative / ItILU0,
solver.hpp:72-76) — the iterative mode has no level serialization at all and
is the fastest on very parallel hardware, exactly why the reference grew
csritsv/ItILU0.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..formats import CSR, to_csr
from ..ops.factorize import ic0, ilu0, ilup, ilut
from ..ops.trisolve import (build_schedule, prepare_offd, solve_schedule,
                            trisolve_jacobi)


def _lu_apply(L: CSR, U: CSR, method: str, sweeps: int):
    if method == "levels":
        ls = build_schedule(L, unit_diag=True)
        us = build_schedule(U)

        def apply(r):
            return solve_schedule(us, solve_schedule(ls, r))
    elif method == "jacobi":
        # csritsv-analysis analog, run NOW (setup phase): the sweep SpMV's
        # off-diagonal operand must exist on the device before the apply
        # closure is traced inside a solver body
        prepare_offd(L)
        prepare_offd(U)

        def apply(r):
            y = trisolve_jacobi(L, r, sweeps=sweeps, unit_diag=True)
            return trisolve_jacobi(U, y, sweeps=sweeps)
    else:
        raise ValueError(f"unknown tri-solve method {method!r}")
    return apply


def ilu(A, p: int = 0, *, method: str = "levels", sweeps: int = 8):
    """ILU(p) preconditioner closure r -> (LU)^{-1} r (reference: ILU
    preconditioner with SetLevel(p))."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    L, U = ilu0(csr) if p == 0 else ilup(csr, p)
    return _lu_apply(L, U, method, sweeps)


def ilut_precond(A, tol: float = 1e-3, max_fill: int = 32, *,
                 method: str = "levels", sweeps: int = 8):
    """ILUT(t, m) preconditioner (reference: ILUT preconditioner)."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    L, U = ilut(csr, tol, max_fill)
    return _lu_apply(L, U, method, sweeps)


def ic(A, *, method: str = "levels", sweeps: int = 8):
    """IC(0) preconditioner: z = L^{-T} L^{-1} r (reference: IC
    preconditioner, LLSolve path)."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    L = ic0(csr)
    Lt = L.transpose_host(device=False)
    if method == "levels":
        ls = build_schedule(L)
        us = build_schedule(Lt)

        def apply(r):
            return solve_schedule(us, solve_schedule(ls, r))
    else:
        prepare_offd(L)
        prepare_offd(Lt)

        def apply(r):
            y = trisolve_jacobi(L, r, sweeps=sweeps)
            return trisolve_jacobi(Lt, y, sweeps=sweeps)
    return apply


def itilu0(A, sweeps: int = 8):
    """ItILU0: ILU(0) factors applied with fixed iterative sweeps
    (reference: ItILU0 preconditioner / rocsparse csritilu0)."""
    return ilu(A, 0, method="jacobi", sweeps=sweeps)


def _flatten_blocks(vals, bcols, brows, nrowb, ncolb, bd, *,
                    unit_diag_blocks: bool):
    """(nnzb, bd, bd) block triplet -> scalar CSR. With
    ``unit_diag_blocks`` an identity diagonal block is appended per block
    row (the factor stores only its off-diagonal blocks)."""
    import numpy as np

    n = nrowb * bd
    nb = len(vals)
    r0 = np.repeat(brows * bd, bd * bd) + np.tile(
        np.repeat(np.arange(bd), bd), nb)
    c0 = np.repeat(bcols * bd, bd * bd) + np.tile(
        np.tile(np.arange(bd), bd), nb)
    v0 = vals.reshape(-1)
    if unit_diag_blocks:
        dr = np.arange(n, dtype=np.int64)
        r0 = np.concatenate([r0, dr])
        c0 = np.concatenate([c0, dr])
        v0 = np.concatenate([v0, np.ones(n, vals.dtype)])
    keep = v0 != 0            # drop structural zeros inside blocks
    # never drop the diagonal itself
    keep |= r0 == c0
    return CSR.from_coo(r0[keep], c0[keep], v0[keep], (n, ncolb * bd))


def bsr_ilu0(A, *, method: str = "levels", sweeps: int = 8):
    """BCSR-native ILU(0) preconditioner: the factorization runs at BLOCK
    granularity (ops/factorize.bsrilu0 — the bsrilu0 numerics, reference
    hip_matrix_bcsr.cpp:747-786 via rocsparse_bsrilu0), then

    * L (unit diagonal blocks) flattens to a scalar unit-lower factor;
    * U is row-transformed by the block-diagonal inverses
      (Ũ = D_U^{-1} U, identity diagonal blocks) so the scalar factor is
      unit-upper — the per-block (bd, bd) solve becomes one batched
      einsum + a unit triangular solve, both data-parallel.

    Apply: z = Ũ^{-1} D_U^{-1} L^{-1} r — exactly (L_b U_b)^{-1} r of the
    block factorization."""
    import numpy as np

    from ..formats.bcsr import BCSR

    assert isinstance(A, BCSR), "bsr_ilu0 wants a BCSR operand"
    from ..ops.factorize import bsrilu0

    (lv, lc, lr), (uv, uc, ur), dinv = bsrilu0(A)
    bd = A.block_dim
    nrowb = dinv.shape[0]
    # Ũ strict-upper blocks: inv(U_ii) @ U_ij (the diagonal blocks of U
    # become exactly I and are appended as the flat unit diagonal)
    upper_strict = uc != ur
    uv2 = np.einsum("nij,njk->nik", dinv[ur[upper_strict]],
                    uv[upper_strict])
    L = _flatten_blocks(lv, lc, lr, nrowb, nrowb, bd,
                        unit_diag_blocks=True)
    Ut = _flatten_blocks(uv2, uc[upper_strict], ur[upper_strict],
                         nrowb, nrowb, bd, unit_diag_blocks=True)
    dinv_j = jnp.asarray(dinv)
    n = A.shape[0]

    if method == "levels":
        ls = build_schedule(L, unit_diag=True)
        us = build_schedule(Ut, unit_diag=True)

        def apply(r):
            y = solve_schedule(ls, r)
            y = _blockdiag_apply(dinv_j, y, bd, n)
            return solve_schedule(us, y)
    else:
        prepare_offd(L)
        prepare_offd(Ut)

        def apply(r):
            y = trisolve_jacobi(L, r, sweeps=sweeps, unit_diag=True)
            y = _blockdiag_apply(dinv_j, y, bd, n)
            return trisolve_jacobi(Ut, y, sweeps=sweeps, unit_diag=True)
    return apply


def _blockdiag_apply(dinv, y, bd, n):
    """x_i = inv(D_ii) @ y_i per block row (one batched einsum)."""
    nrowb = dinv.shape[0]
    pad = nrowb * bd - y.shape[0]
    yp = jnp.concatenate([y, jnp.zeros((pad,), y.dtype)]) if pad else y
    xb = jnp.einsum("nij,nj->ni", dinv, yp.reshape(nrowb, bd),
                    precision=jax.lax.Precision.HIGHEST)
    return xb.reshape(-1)[:n]


def bsr_ic0(A, *, method: str = "levels", sweeps: int = 8):
    """BCSR-native IC(0): block Cholesky factor (ops/factorize.bsric0,
    reference rocsparse_bsric0); the flattened factor is genuinely scalar
    lower-triangular (Cholesky diagonal blocks are lower-triangular), so
    the standard LLᵀ solve machinery applies unchanged."""
    import numpy as np

    from ..formats.bcsr import BCSR

    assert isinstance(A, BCSR), "bsr_ic0 wants a BCSR operand"
    from ..ops.factorize import bsric0

    vals, cols, rows = bsric0(A)
    bd = A.block_dim
    nrowb = -(-A.shape[0] // bd)
    L = _flatten_blocks(vals, cols, rows, nrowb, nrowb, bd,
                        unit_diag_blocks=False)
    Lt = L.transpose_host(device=False)
    if method == "levels":
        ls = build_schedule(L)
        us = build_schedule(Lt)

        def apply(r):
            return solve_schedule(us, solve_schedule(ls, r))
    else:
        prepare_offd(L)
        prepare_offd(Lt)

        def apply(r):
            y = trisolve_jacobi(L, r, sweeps=sweeps)
            return trisolve_jacobi(Lt, y, sweeps=sweeps)
    return apply
