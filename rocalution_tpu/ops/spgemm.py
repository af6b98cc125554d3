"""Sparse matrix–matrix operations (setup phase).

Reference parity: LocalMatrix::MatMatMult (SpGEMM, Symbolic+Numeric),
MatrixAdd (SpGEAM), TripleMatrixProduct (Galerkin R·A·P), Transpose
(src/base/local_matrix.hpp; HIP via rocsparse csrgemm/csrgeam).

Placement: SpGEMM output sparsity is data-dependent, which is
fundamentally at odds with XLA's static shapes (SURVEY.md §7 "hard parts"),
and in the solver library SpGEMM appears only in *setup* (AMG Galerkin
products, power patterns, Schur complements). So the symbolic+numeric passes
run on the host (scipy's C++ SpGEMM — itself a native-code path), and the
resulting static-shape operators live on device for the solve phase. The
numeric-only refresh (`spgemm_numeric_update`) recomputes values on a frozen
pattern and IS device-friendly (segment-sum over a precomputed triple list)
— the analog of ReBuildNumeric.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import CSR
from ..formats.base import get_host


def _scipy(A: CSR):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (get_host(A, "data"), get_host(A, "indices").astype(np.int64),
         get_host(A, "indptr").astype(np.int64)), shape=A.shape,
    )


def from_scipy(S) -> CSR:
    C = S.tocoo()
    return CSR.from_coo(C.row, C.col, C.data, C.shape)


def spmm_host(Sa, Sb):
    """scipy-CSR @ scipy-CSR through the native two-thread Gustavson
    kernel when available (sorted rows; the reference's csrgemm analog,
    hip_matrix_csr.cpp MatMatMult); scipy fallback otherwise. Both the
    serial AMG builders and the distributed per-part Galerkin sweeps
    route through here."""
    import scipy.sparse as sp

    from .. import native

    if (native.available() and Sa.dtype == np.float64
            and Sb.dtype == np.float64):
        Sa, Sb = Sa.tocsr(), Sb.tocsr()
        ptr, col, val = native.spgemm(Sa.indptr, Sa.indices, Sa.data,
                                      Sb.indptr, Sb.indices, Sb.data,
                                      Sb.shape[1])
        return sp.csr_matrix((val, col, ptr),
                             shape=(Sa.shape[0], Sb.shape[1]))
    return (Sa @ Sb).tocsr()


def spgemm(A: CSR, B: CSR) -> CSR:
    """C = A @ B (reference: LocalMatrix::MatMatMult / csrgemm)."""
    return from_scipy(spmm_host(_scipy(A), _scipy(B)))


def spgeam(A: CSR, B: CSR, alpha=1.0, beta=1.0) -> CSR:
    """C = alpha A + beta B (reference: LocalMatrix::MatrixAdd / csrgeam)."""
    return from_scipy((alpha * _scipy(A) + beta * _scipy(B)).tocsr())


def transpose(A: CSR) -> CSR:
    """A^T (reference: LocalMatrix::Transpose)."""
    return A.transpose_host()


def triple_product(R: CSR, A: CSR, P: CSR) -> CSR:
    """Galerkin product R A P (reference: LocalMatrix::TripleMatrixProduct —
    the AMG coarse-operator construction)."""
    return from_scipy(spmm_host(spmm_host(_scipy(R), _scipy(A)), _scipy(P)))


def spgemm_plan(A: CSR, B: CSR):
    """Symbolic pass returning (pattern CSR of C, device numeric-update fn).

    The update fn recomputes C.data from new A.data/B.data on the FROZEN
    pattern entirely on device (one multiply + segment_sum) — the analog of
    ReBuildNumeric for Galerkin refresh without re-running symbolic SpGEMM.
    """
    Sa, Sb = _scipy(A), _scipy(B)
    pat = (abs(Sa) @ abs(Sb)).tocsr()
    pat.sort_indices()   # scipy SpGEMM leaves indices unsorted
    C = from_scipy(pat)
    # triple list: every scalar product a_ik * b_kj contributing to c_ij
    a_coo = Sa.tocoo()
    ai, ak, apos = a_coo.row, a_coo.col, np.arange(Sa.nnz)
    # expand: for each A nonzero (i,k), all B nonzeros in row k
    bptr = Sb.indptr.astype(np.int64)
    counts = np.diff(bptr)[ak]
    total = int(counts.sum())
    rep_ai = np.repeat(ai, counts)
    rep_apos = np.repeat(apos, counts)
    # ragged expand of [bptr[k], bptr[k]+counts) without a Python loop
    cum = np.concatenate([[0], np.cumsum(counts)])[:-1]
    boffsets = (np.repeat(bptr[ak], counts)
                + np.arange(total) - np.repeat(cum, counts))
    bj = Sb.indices[boffsets].astype(np.int64)
    # map (i, j) -> position in C pattern: CSR ordering makes the combined
    # key row*ncol+col globally sorted, so one searchsorted suffices
    ncol = pat.shape[1]
    crow = np.repeat(np.arange(pat.shape[0], dtype=np.int64),
                     np.diff(pat.indptr))
    ckeys = crow * ncol + pat.indices.astype(np.int64)
    cpos = np.searchsorted(ckeys, rep_ai.astype(np.int64) * ncol + bj)
    rep_apos_j = jnp.asarray(rep_apos)
    boffsets_j = jnp.asarray(boffsets)
    cpos_j = jnp.asarray(cpos)
    nnz_c = pat.nnz

    def numeric(a_data, b_data):
        prod = a_data[rep_apos_j] * b_data[boffsets_j]
        return jax.ops.segment_sum(prod, cpos_j, num_segments=nnz_c)

    return C, numeric


def triple_product_plan(R: CSR, A: CSR, P: CSR):
    """Symbolic-once / numeric-on-device Galerkin: returns
    (pattern CSR of R·A·P, update fn).

    The symbolic pass (two host SpGEMM patterns, R and P frozen) runs once;
    `update(a_data)` then recomputes the coarse values entirely on device —
    the analog of the reference's ReBuildNumeric path reusing the csrgemm
    info structure (LocalMatrix::TripleMatrixProduct + ReBuildNumeric,
    local_matrix.cpp; hip csrgemm numeric stage, hip_matrix_csr.cpp)."""
    B, num_ap = spgemm_plan(A, P)
    C, num_rb = spgemm_plan(R, B)
    r_data = R.data
    p_data = P.data

    def update(a_data):
        b_data = num_ap(a_data, p_data)
        return num_rb(r_data, b_data)

    return C, update
