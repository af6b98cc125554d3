"""Approximate-inverse preconditioners: FSAI, SPAI, TNS, AIChebyshev.

Reference parity: preconditioner_ai.{hpp,cpp} — AIChebyshev (matrix-valued
Chebyshev polynomial of A^{-1}), FSAI(q) (factorized sparse approximate
inverse over the power-q lower pattern), SPAI (Frobenius-minimal sparse
approximate inverse), TNS (truncated Neumann series).

Design: the reference computes FSAI/SPAI with *host-only* kernels
(absent from hip_matrix_csr.hpp); here their setup reduces to BATCHED small
dense solves — (n, m, m) solves / normal equations. The applies are pure
SpMV chains, the most data-parallel preconditioner class in the library
(no triangular recurrences at all).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import CSR, to_csr
from ..formats.base import get_host
from ..ops.spmv import spmv
from .jacobi import extract_diagonal


def _scipy_csr(A: CSR):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (get_host(A, "data"), get_host(A, "indices").astype(np.int64),
         get_host(A, "indptr").astype(np.int64)),
        shape=A.shape,
    )


def _power_lower_pattern(S, q: int):
    """Row index lists of the lower triangle (incl diag) of pattern |S|^q."""
    P = S.copy()
    P.data[:] = 1.0
    Sq = P
    for _ in range(q - 1):
        Sq = (Sq @ P).tocsr()
        Sq.data[:] = 1.0
    import scipy.sparse as sp

    L = sp.tril(Sq).tocsr()
    return [
        L.indices[L.indptr[i]:L.indptr[i + 1]] for i in range(S.shape[0])
    ]


def fsai_matrices(A, q: int = 1):
    """Build the FSAI(q) factor pair (G, G^T) as CSR matrices — used by the
    local closure below and by the distributed BlockJacobi builder
    (parallel/precond.py), which stacks per-block factors."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    S = _scipy_csr(csr)
    n = csr.shape[0]
    patt = _power_lower_pattern(S, max(q, 1))
    m = max(len(J) for J in patt)
    Sd = S.tolil()

    blocks = np.tile(np.eye(m, dtype=S.dtype), (n, 1, 1))
    rhs = np.zeros((n, m), dtype=S.dtype)
    for i in range(n):
        J = patt[i]
        k = len(J)
        blocks[i, :k, :k] = Sd[J, :][:, J].toarray()
        rhs[i, k - 1] = 1.0  # J sorted ascending; diagonal entry last

    # batched small solves on the host: setup-phase work
    g = np.linalg.solve(blocks, rhs[..., None]).squeeze(-1)
    rows, cols, vals = [], [], []
    for i in range(n):
        J = patt[i]
        k = len(J)
        gi = g[i, :k]
        d = gi[-1]
        if d <= 0:
            raise ValueError(f"FSAI breakdown at row {i} (pivot {d})")
        gi = gi / np.sqrt(d)
        rows.extend([i] * k)
        cols.extend(J.tolist())
        vals.extend(gi.tolist())
    G = CSR.from_coo(rows, cols, np.asarray(vals, S.dtype), (n, n))
    return G, G.transpose_host()


def fsai(A, q: int = 1):
    """FSAI(q): G ≈ L^{-1} (inverse Cholesky factor) over the lower pattern
    of |A|^q; M^{-1} = G^T G (reference: FSAI preconditioner, SetPrecondMat
    power(q) pattern).

    Setup = one batched (n, m, m) dense solve; apply = two SpMVs.
    """
    G, Gt = fsai_matrices(A, q)

    def apply(r):
        return spmv(Gt, spmv(G, r))

    return apply


def spai_matrix(A) -> CSR:
    """Build the SPAI matrix M (min ||A M - I||_F over A's pattern) — used
    by the local closure below and the distributed BlockJacobi builder."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    S = _scipy_csr(csr)
    n = csr.shape[0]
    Sc = S.tocsc()

    Js = [Sc.indices[Sc.indptr[j]:Sc.indptr[j + 1]] for j in range(n)]
    mJ = max(len(J) for J in Js)
    # normal equations: (A[:,J]^T A[:,J]) m = A[:,J]^T e_j
    AtA = np.tile(np.eye(mJ, dtype=S.dtype), (n, 1, 1))
    Atb = np.zeros((n, mJ), dtype=S.dtype)
    for j in range(n):
        J = Js[j]
        k = len(J)
        Aj = Sc[:, J]                  # (n, k) sparse, few rows
        AtA[j, :k, :k] = (Aj.T @ Aj).toarray()
        # A[:,J]^T e_j = A[j, J]
        Atb[j, :k] = np.asarray(Aj.getrow(j).todense()).ravel()
    mvals = np.linalg.solve(AtA, Atb[..., None]).squeeze(-1)
    rows, cols, vals = [], [], []
    for j in range(n):
        J = Js[j]
        k = len(J)
        rows.extend(J.tolist())
        cols.extend([j] * k)
        vals.extend(mvals[j, :k].tolist())
    return CSR.from_coo(rows, cols, np.asarray(vals, S.dtype), (n, n))


def spai(A):
    """SPAI: M minimizing ||A M - I||_F over the pattern of A; apply = one
    SpMV (reference: SPAI preconditioner, host-only kernel there — batched
    normal-equation solves here)."""
    M = spai_matrix(A)
    return lambda r: spmv(M, r)


def tns(A, order: int = 2):
    """TNS: truncated Neumann series M^{-1} = sum_{k<=q} (I - D^{-1}A)^k
    D^{-1} applied by Horner — q SpMVs per apply (reference: TNS
    preconditioner)."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    d = extract_diagonal(csr)
    inv_d = jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), 1.0)

    def apply(r):
        dinv_r = inv_d * r if r.ndim == 1 else inv_d[:, None] * r
        z = dinv_r
        for _ in range(order):
            az = spmv(csr, z)
            z = dinv_r + z - (inv_d * az if r.ndim == 1 else inv_d[:, None] * az)
        return z

    return apply


def aichebyshev(A, degree: int = 4, lambda_min=None, lambda_max=None):
    """AIChebyshev: z = p(A) r with p the degree-`degree` Chebyshev
    approximation of 1/x on [lambda_min, lambda_max] (reference:
    AIChebyshev, needs Gershgorin bounds — computed here if omitted).

    Matrix-free apply: `degree` SpMVs, zero setup storage.
    """
    from ..ops.spectral import gershgorin

    csr = A if isinstance(A, CSR) else to_csr(A)
    if lambda_min is None or lambda_max is None:
        lo, hi = gershgorin(csr)
        lambda_min = float(lo) if lambda_min is None else lambda_min
        lambda_max = float(hi) if lambda_max is None else lambda_max
        # keep the interval positive and not absurdly wide: a low-degree
        # polynomial cannot track 1/x over many decades, so clamp the lower
        # bound to lambda_max/30 (Gershgorin's lower bound is often 0 for
        # M-matrices; the reference requires user-set bounds instead)
        lambda_min = max(lambda_min, lambda_max / 30.0)
    theta = (lambda_max + lambda_min) / 2.0
    delta = (lambda_max - lambda_min) / 2.0
    sigma1 = theta / delta

    def apply(r):
        # Chebyshev semi-iteration on A z = r starting from 0 — after
        # `degree` steps z = p_degree(A) r
        z = r / theta
        d = z
        rho = 1.0 / sigma1
        res = r - spmv(csr, z)
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * res
            z = z + d
            res = res - spmv(csr, d)
            rho = rho_new
        return z

    return apply
