"""Incomplete factorizations (setup phase).

Reference parity: LocalMatrix::ILU0Factorize / ICFactorize /
ILUpFactorize(p) / ILUTFactorize(t, maxrow) (src/base/local_matrix.hpp
factorization drivers; host kernels in host_matrix_csr.cpp and
host_ilut_driver_csr.cpp — ILUT/ILUp are host-only in the reference too).

Placement: factorization is sequential setup work — it runs once
per matrix on the host (numpy), while the *apply* path (triangular solves)
runs on-device via LevelSchedule scans or iterative sweeps (ops/trisolve).
Returned factors are CSR pytrees ready for device residency.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..formats import CSR
from ..formats.base import get_host


def _host(A: CSR):
    data = get_host(A, "data").copy()
    cols = get_host(A, "indices").astype(np.int64)
    indptr = get_host(A, "indptr").astype(np.int64)
    return data, cols, indptr


def _diag_ptrs(cols, indptr, n):
    dp = np.empty(n, dtype=np.int64)
    for i in range(n):
        rs, re = indptr[i], indptr[i + 1]
        pos = np.searchsorted(cols[rs:re], i)
        if pos >= re - rs or cols[rs + pos] != i:
            raise ValueError(f"row {i} has no diagonal entry")
        dp[i] = rs + pos
    return dp


def _split_lu(data, cols, indptr, n, unit_lower=True):
    """Split a factorized in-place CSR into (L unit-lower incl diag=1,
    U upper incl diag)."""
    rows = np.repeat(np.arange(n), np.diff(indptr))
    lower = cols < rows
    upper = cols > rows
    diag = cols == rows
    ld = np.concatenate([data[lower], np.ones(n, data.dtype)])
    lr = np.concatenate([rows[lower], np.arange(n)])
    lc = np.concatenate([cols[lower], np.arange(n)])
    L = CSR.from_coo(lr, lc, ld, (n, n), device=False)
    ud = np.concatenate([data[upper], data[diag]])
    ur = np.concatenate([rows[upper], rows[diag]])
    uc = np.concatenate([cols[upper], cols[diag]])
    U = CSR.from_coo(ur, uc, ud, (n, n), device=False)
    return L, U


def _ilu0_numeric(data, cols, indptr, n):
    """In-place IKJ ILU(0) on a fixed pattern (columns sorted per row)."""
    dp = _diag_ptrs(cols, indptr, n)
    for i in range(n):
        rs, re = indptr[i], indptr[i + 1]
        ci = cols[rs:re]
        for idx in range(rs, dp[i]):
            k = cols[idx]
            dk = data[dp[k]]
            if dk == 0:
                raise ZeroDivisionError(f"zero pivot at row {k}")
            lik = data[idx] / dk
            data[idx] = lik
            krs, kre = dp[k] + 1, indptr[k + 1]
            if krs < kre:
                kcols = cols[krs:kre]
                pos = np.searchsorted(ci, kcols)
                valid = pos < (re - rs)
                safe = np.minimum(pos, re - rs - 1)
                valid &= ci[safe] == kcols
                data[rs + pos[valid]] -= lik * data[krs:kre][valid]
    return data


def _use_native(data) -> bool:
    from .. import native

    # f32 inputs upcast to f64 for the native sweep and cast back — the
    # sweep is sequential host work where the f64 copy is noise, while
    # the numpy fallback costs seconds at 65k rows
    return data.dtype in (np.float32, np.float64) and native.available()


def ilu0(A: CSR) -> Tuple[CSR, CSR]:
    """ILU(0): incomplete LU on the sparsity pattern of A.

    Returns (L, U) with L unit-lower (explicit 1s on the diagonal) and U
    upper including the diagonal, so A ≈ L @ U (reference:
    LocalMatrix::ILU0Factorize). Uses the native C++ sweep when available
    (rocalution_tpu.native), numpy otherwise.
    """
    data, cols, indptr = _host(A)
    n = A.shape[0]
    if _use_native(data):
        from .. import native

        cols32 = cols.astype(np.int32)
        d64 = data.astype(np.float64, copy=False)
        native.ilu0_inplace(indptr.astype(np.int64), cols32, d64)
        data = d64.astype(data.dtype, copy=False)
    else:
        data = _ilu0_numeric(data, cols, indptr, n)
    return _split_lu(data, cols, indptr, n)


def ic0(A: CSR) -> CSR:
    """IC(0): incomplete Cholesky on the lower pattern of A.

    Returns L (lower triangular incl diagonal) with A ≈ L @ L.T
    (reference: LocalMatrix::ICFactorize).
    """
    data, cols, indptr = _host(A)
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(indptr))
    lsel = cols <= rows
    lr, lc, lv = rows[lsel], cols[lsel], data[lsel]
    lptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(lptr, lr + 1, 1)
    lptr = np.cumsum(lptr)

    if _use_native(lv):
        from .. import native

        lv64 = lv.astype(np.float64, copy=False)
        native.ic0_inplace(lptr.astype(np.int64), lc.astype(np.int32), lv64)
        return CSR.from_coo(lr, lc, lv64.astype(lv.dtype, copy=False),
                            (n, n), device=False)

    for i in range(n):
        rs, re = lptr[i], lptr[i + 1]
        ci = lc[rs:re]
        for idx in range(rs, re - 1):        # off-diagonal j < i
            j = ci[idx - rs]
            js, je = lptr[j], lptr[j + 1]
            cj = lc[js:je - 1]               # row j cols < j
            # dot over common pattern cols < j
            ci_part = ci[: idx - rs]
            pos = np.searchsorted(ci_part, cj)
            valid = pos < len(ci_part)
            safe = np.minimum(pos, max(len(ci_part) - 1, 0))
            if len(ci_part):
                valid &= ci_part[safe] == cj
            else:
                valid[:] = False
            s = np.dot(lv[rs + pos[valid]], lv[js:je - 1][valid])
            djj = lv[je - 1]
            if djj == 0:
                raise ZeroDivisionError(f"zero pivot at row {j}")
            lv[idx] = (lv[idx] - s) / djj
        s = np.dot(lv[rs:re - 1], lv[rs:re - 1])
        val = lv[re - 1] - s
        if val <= 0:
            raise ValueError(f"IC(0) breakdown at row {i} (pivot {val})")
        lv[re - 1] = np.sqrt(val)
    return CSR.from_coo(lr, lc, lv, (n, n), device=False)


def _symbolic_ilup(cols, indptr, n, p):
    """Level-of-fill symbolic phase of ILU(p). Returns expanded pattern
    (rows, cols) including fill-in of level <= p."""
    out_rows, out_cols = [], []
    upper = [None] * n  # per-row list of (col > i, level)
    for i in range(n):
        lev = {}
        for c in cols[indptr[i]:indptr[i + 1]]:
            lev[int(c)] = 0
        ks = sorted(c for c in lev if c < i)
        seen = set(ks)
        while ks:
            k = ks.pop(0)
            lev_ik = lev[k]
            if lev_ik > p:
                continue
            for j, lev_kj in upper[k]:
                f = lev_ik + lev_kj + 1
                if f <= p and (j not in lev or lev[j] > f):
                    lev[j] = min(lev.get(j, f), f)
                    if j < i and j not in seen:
                        seen.add(j)
                        # keep ks sorted ascending
                        import bisect
                        bisect.insort(ks, j)
        cs = sorted(lev)
        out_rows.extend([i] * len(cs))
        out_cols.extend(cs)
        upper[i] = [(j, lev[j]) for j in cs if j > i]
    return np.asarray(out_rows, np.int64), np.asarray(out_cols, np.int64)


def ilup(A: CSR, p: int = 1) -> Tuple[CSR, CSR]:
    """ILU(p): level-of-fill incomplete LU (reference:
    LocalMatrix::ILUpFactorize, power(q)-pattern variant in
    MultiColoredILU). Returns (L, U) like ilu0."""
    if p == 0:
        return ilu0(A)
    data, cols, indptr = _host(A)
    n = A.shape[0]
    frows, fcols = _symbolic_ilup(cols, indptr, n, p)
    # scatter A values onto the expanded pattern
    fptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(fptr, frows + 1, 1)
    fptr = np.cumsum(fptr)
    fdata = np.zeros(len(frows), dtype=data.dtype)
    # scatter A's values into the expanded pattern row by row
    for i in range(n):
        ars, are = indptr[i], indptr[i + 1]
        frs, fre = fptr[i], fptr[i + 1]
        idx = np.searchsorted(fcols[frs:fre], cols[ars:are])
        fdata[frs + idx] = data[ars:are]
    if _use_native(fdata):
        from .. import native

        native.ilu0_inplace(fptr.astype(np.int64),
                            fcols.astype(np.int32), fdata)
    else:
        fdata = _ilu0_numeric(fdata, fcols, fptr, n)
    return _split_lu(fdata, fcols, fptr, n)


def ilut(A: CSR, tol: float = 1e-3, max_fill: int = 32) -> Tuple[CSR, CSR]:
    """ILUT(t, m): threshold + max-fill incomplete LU (reference:
    LocalMatrix::ILUTFactorize, host_ilut_driver_csr.cpp). Returns (L, U)
    like ilu0."""
    data, cols, indptr = _host(A)
    n = A.shape[0]
    if _use_native(data):
        from .. import native

        lr, lc, lv, ur, uc, uv = native.ilut(
            indptr.astype(np.int64), cols.astype(np.int32), data,
            tol, max_fill,
        )
        lr = np.concatenate([lr, np.arange(n)])
        lc = np.concatenate([lc, np.arange(n)])
        lv = np.concatenate([lv, np.ones(n, data.dtype)])
        L = CSR.from_coo(lr, lc, lv, (n, n), device=False)
        U = CSR.from_coo(ur, uc, uv, (n, n), device=False)
        return L, U
    U_rows = [None] * n   # (cols >= k asc, vals); diag first position
    L_out_r, L_out_c, L_out_v = [], [], []

    for i in range(n):
        rs, re = indptr[i], indptr[i + 1]
        w = dict(zip(cols[rs:re].tolist(), data[rs:re].tolist()))
        row_norm = float(np.linalg.norm(data[rs:re])) or 1.0
        drop = tol * row_norm
        ks = sorted(c for c in w if c < i)
        import bisect
        seen = set(ks)
        while ks:
            k = ks.pop(0)
            ucols, uvals = U_rows[k]
            lik = w[k] / uvals[0]          # U diag first
            if abs(lik) < drop:
                del w[k]
                continue
            w[k] = lik
            for c, v in zip(ucols[1:], uvals[1:]):
                nv = w.get(c, 0.0) - lik * v
                w[c] = nv
                if c < i and c not in seen:
                    seen.add(c)
                    bisect.insort(ks, c)
        if i not in w:
            raise ZeroDivisionError(f"ILUT lost the diagonal at row {i}")
        lw = [(c, v) for c, v in w.items() if c < i and abs(v) >= drop]
        uw = [(c, v) for c, v in w.items() if c > i and abs(v) >= drop]
        lw.sort(key=lambda cv: -abs(cv[1]))
        uw.sort(key=lambda cv: -abs(cv[1]))
        lw = sorted(lw[:max_fill])
        uw = sorted(uw[:max_fill])
        dval = w[i]
        if dval == 0:
            raise ZeroDivisionError(f"ILUT zero pivot at row {i}")
        for c, v in lw:
            L_out_r.append(i); L_out_c.append(c); L_out_v.append(v)
        U_rows[i] = (
            np.asarray([i] + [c for c, _ in uw], np.int64),
            np.asarray([dval] + [v for _, v in uw], data.dtype),
        )

    # assemble L (unit diag) and U
    L_out_r.extend(range(n)); L_out_c.extend(range(n))
    L_out_v.extend([1.0] * n)
    L = CSR.from_coo(L_out_r, L_out_c, np.asarray(L_out_v, data.dtype), (n, n),
                     device=False)
    ur = np.concatenate([np.full(len(U_rows[i][0]), i) for i in range(n)])
    uc = np.concatenate([U_rows[i][0] for i in range(n)])
    uv = np.concatenate([U_rows[i][1] for i in range(n)])
    U = CSR.from_coo(ur, uc, uv, (n, n), device=False)
    return L, U


# --------------------------------------------------------------------------
# BCSR-native factorizations (reference: rocsparse bsrilu0/bsric0 behind
# HIPAcceleratorMatrixBCSR::{ILU0,IC0}Factorize, hip_matrix_bcsr.cpp:
# 747-786). The factorization works on DENSE (bd, bd) blocks over the
# BLOCK sparsity pattern — different (usually stronger) numerics than a
# scalar ILU of the flattened matrix. Setup is a host sweep (like every
# factorization driver here); applies ride the scalar LevelSchedule
# machinery on flattened factors after a block-diagonal transform (see
# precond/ilu.bsr_ilu0) so each (bd, bd) triangular solve becomes one
# batched dense product.
# --------------------------------------------------------------------------

def _bcsr_host(A):
    """(blocks, bcols, bindptr, nrowb, bd) from host caches only."""
    from ..formats.bcsr import BCSR

    assert isinstance(A, BCSR)
    blocks = get_host(A, "data").copy()
    bcols = get_host(A, "indices").astype(np.int64)
    brows = get_host(A, "row_ids").astype(np.int64)
    nrowb = -(-A.shape[0] // A.block_dim)
    bindptr = np.concatenate(
        ([0], np.cumsum(np.bincount(brows, minlength=nrowb))))
    return blocks, bcols, bindptr, nrowb, A.block_dim


def bsrilu0(A):
    """Block-level ILU(0): zero-fill incomplete LU over the BLOCK pattern
    (IKJ sweep; each op is a dense (bd, bd) matmul/inverse).

    Returns (L_blocks, U_blocks, inv_diag) as
    ((nnzb_l, bd, bd), cols, indptr) triplets of numpy arrays plus the
    (nrowb, bd, bd) inverses of the U diagonal blocks — consumed by
    precond.bsr_ilu0. Reference: rocsparse_bsrilu0.
    """
    blocks, bcols, bindptr, nrowb, bd = _bcsr_host(A)
    # position lookup (row, col) -> block index
    pos = {}
    for i in range(nrowb):
        for p in range(bindptr[i], bindptr[i + 1]):
            pos[(i, int(bcols[p]))] = p
    diag_inv = np.zeros((nrowb, bd, bd), blocks.dtype)
    for i in range(nrowb):
        rs, re = bindptr[i], bindptr[i + 1]
        row_cols = bcols[rs:re]
        for p in range(rs, re):
            k = int(bcols[p])
            if k >= i:
                break
            # A_ik <- A_ik @ inv(U_kk)
            blocks[p] = blocks[p] @ diag_inv[k]
            # A_ij -= A_ik @ A_kj for j > k in both patterns
            ks, ke = bindptr[k], bindptr[k + 1]
            for q in range(ks, ke):
                j = int(bcols[q])
                if j <= k:
                    continue
                pj = pos.get((i, j))
                if pj is not None:
                    blocks[pj] = blocks[pj] - blocks[p] @ blocks[q]
        pd = pos.get((i, i))
        if pd is None:
            raise ValueError(f"block row {i} has no diagonal block")
        diag_inv[i] = np.linalg.inv(blocks[pd])
    lower = np.repeat(np.arange(nrowb), np.diff(bindptr)) > bcols
    upper = ~lower
    def _triplet(mask):
        rows = np.repeat(np.arange(nrowb), np.diff(bindptr))[mask]
        return blocks[mask], bcols[mask], rows
    return _triplet(lower), _triplet(upper), diag_inv


def bsric0(A):
    """Block-level IC(0): zero-fill incomplete Cholesky over the BLOCK
    pattern (A ≈ L_b L_bᵀ with lower-triangular Cholesky diagonal
    blocks). Returns ((nnzb_l, bd, bd) blocks incl. diagonal, cols, rows)
    numpy triplet of the block-lower factor. Reference: rocsparse_bsric0.
    """
    blocks, bcols, bindptr, nrowb, bd = _bcsr_host(A)
    pos = {}
    for i in range(nrowb):
        for p in range(bindptr[i], bindptr[i + 1]):
            pos[(i, int(bcols[p]))] = p
    Lb = {}
    for i in range(nrowb):
        rs, re = bindptr[i], bindptr[i + 1]
        for p in range(rs, re):
            j = int(bcols[p])
            if j > i:
                continue
            S = blocks[p].copy()
            # S -= sum_k<j L_ik @ L_jk^T over common k
            for k in range(0, j):
                Lik = Lb.get((i, k))
                Ljk = Lb.get((j, k))
                if Lik is not None and Ljk is not None:
                    S = S - Lik @ Ljk.T
            if j < i:
                # L_ij = S @ inv(L_jj)^T
                Ljj = Lb[(j, j)]
                Lb[(i, j)] = np.linalg.solve(Ljj, S.T).T
            else:
                Lb[(i, i)] = np.linalg.cholesky(S)
    keys = sorted(Lb.keys())
    rows = np.asarray([k[0] for k in keys], np.int64)
    cols = np.asarray([k[1] for k in keys], np.int64)
    vals = np.stack([Lb[k] for k in keys]).astype(blocks.dtype)
    return vals, cols, rows
