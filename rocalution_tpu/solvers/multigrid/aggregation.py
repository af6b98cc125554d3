"""Aggregation-based AMG: smoothed (SA), unsmoothed (UA), pairwise.

Reference parity:
- SAAMG (smoothed_amg.{hpp,cpp}): AMGConnect (coupling strength) →
  AMGGreedyAggregate | AMGPMISAggregate → AMGSmoothedAggregation
  P = (I - ω D^{-1} A_f) P̂, SetCouplingStrength/SetInterpRelax/
  SetCoarseningStrategy/SetLumpingStrategy (smoothed_amg.hpp:61-72).
- UAAMG (unsmoothed_amg.{hpp,cpp}): binary P̂ + SetOverInterp scaling.
- PairwiseAMG (pairwise_amg.{hpp,cpp}): Notay pairwise matching with
  SetBeta/SetCoarseningFactor (pairwise_amg.hpp:83-97).

All of this is setup-phase graph work → host numpy/scipy (vectorized Luby
rounds for PMIS, same parallel-heuristic family as the reference's device
aggregation kernels, hip_matrix_csr SA/UA aggregation); the produced
hierarchy is static-shape device data.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ...formats import CSR
from ...formats.base import get_host


def _scipy(A: CSR):
    import scipy.sparse as sp

    # native index dtype as-is: int64 astype copies cost seconds at
    # millions of nnz, and scipy handles int32/int64 equally
    return sp.csr_matrix(
        (get_host(A, "data"), get_host(A, "indices"),
         get_host(A, "indptr")), shape=A.shape,
    )


def _pattern_member(C, rows, cols) -> np.ndarray:
    """Vectorized membership test: is (rows[k], cols[k]) a stored entry of
    pattern C? (CSR keys are globally sorted -> one searchsorted)."""
    C = C.tocsr()
    C.sort_indices()
    ncol = C.shape[1]
    crow = np.repeat(np.arange(C.shape[0], dtype=np.int64),
                     np.diff(C.indptr))
    ckeys = crow * ncol + C.indices.astype(np.int64)
    keys = rows.astype(np.int64) * ncol + cols.astype(np.int64)
    if len(ckeys) == 0:
        return np.zeros(len(keys), dtype=bool)
    pos = np.searchsorted(ckeys, keys)
    pos_safe = np.minimum(pos, len(ckeys) - 1)
    return ckeys[pos_safe] == keys


def strength_connect(S, eps: float = 0.08):
    """Symmetric SA strength graph: |a_ij| >= eps sqrt(|a_ii a_jj|)
    (reference: LocalMatrix::AMGConnect with coupling strength)."""
    import scipy.sparse as sp

    d = np.abs(S.diagonal())
    C = S.tocoo()
    keep = (C.row != C.col) & (
        np.abs(C.data) >= eps * np.sqrt(d[C.row] * d[C.col])
    )
    return sp.csr_matrix(
        (np.ones(keep.sum(), np.int8), (C.row[keep], C.col[keep])),
        shape=S.shape,
    )


def greedy_aggregate(C) -> np.ndarray:
    """Vaněk greedy aggregation (reference: AMGGreedyAggregate).

    Pass 1: nodes whose strong neighborhood is fully unaggregated seed an
    aggregate with it; pass 2: leftovers join an adjacent aggregate;
    pass 3: remaining leftovers seed their own aggregates.
    Returns agg[i] in [0, n_agg) (isolated nodes get singletons).

    The sweep is inherently sequential (each decision depends on all
    previous ones); it runs in the native C++ layer when available —
    the analog of the reference's host aggregation kernel — with this
    per-node Python loop as fallback.
    """
    from ... import native

    if native.available():
        return native.greedy_aggregate(C.indptr, C.indices)
    n = C.shape[0]
    agg = np.full(n, -1, np.int64)
    na = 0
    indptr, indices = C.indptr, C.indices
    for i in range(n):
        if agg[i] != -1:
            continue
        nbr = indices[indptr[i]:indptr[i + 1]]
        if len(nbr) and np.all(agg[nbr] == -1):
            agg[i] = na
            agg[nbr] = na
            na += 1
    for i in range(n):
        if agg[i] != -1:
            continue
        nbr = indices[indptr[i]:indptr[i + 1]]
        assigned = nbr[agg[nbr] != -1]
        if len(assigned):
            agg[i] = agg[assigned[0]]
    for i in range(n):
        if agg[i] == -1:
            agg[i] = na
            na += 1
    return agg


def pmis_aggregate(C, seed: int = 0) -> np.ndarray:
    """PMIS-style aggregation: Luby-selected distance-2 independent roots,
    neighbors join their root, leftovers attach greedily (reference:
    AMGPMISAggregate — the device-parallel strategy)."""
    n = C.shape[0]
    rng = np.random.default_rng(seed)
    w = rng.permutation(n).astype(np.float64)
    C32 = C.astype(np.int32)
    # int32 before the product: int8 C @ C overflows (and can wrap a path
    # count to exactly 0) once a row has >=127 shared strong neighbors.
    C2 = (C32 + C32 @ C32).tocsr()              # distance-2 adjacency
    C2.setdiag(0)                     # self-paths would veto every maximum
    C2.eliminate_zeros()
    agg = np.full(n, -1, np.int64)
    candidate = np.ones(n, bool)
    roots = []
    while candidate.any():
        wa = np.where(candidate, w, -np.inf)
        nbr_max = np.full(n, -np.inf)
        ne = np.diff(C2.indptr) > 0
        if C2.nnz:
            red = np.maximum.reduceat(wa[C2.indices], C2.indptr[:-1][ne])
            nbr_max[ne] = red
        sel = candidate & (w > nbr_max)
        idx = np.where(sel)[0]
        if not len(idx):
            break
        roots.extend(idx.tolist())
        candidate[idx] = False
        knocked = np.zeros(n, bool)
        knocked[C2[idx].indices] = True
        candidate &= ~knocked
    roots = np.asarray(roots, np.int64)
    agg[roots] = np.arange(len(roots))
    # neighbors of roots join a root's aggregate (vectorized scatter; on a
    # conflict any adjacent root is valid — last write wins)
    root_deg = (C.indptr[roots + 1] - C.indptr[roots]).astype(np.int64)
    if root_deg.sum():
        nbr = _gather_rows(C, roots)
        owner = np.repeat(np.arange(len(roots)), root_deg)
        free = agg[nbr] == -1
        agg[nbr[free]] = owner[free]
    # leftovers: join any adjacent aggregate, else singleton (vectorized:
    # per-row max of neighbor agg ids — any assigned neighbor is valid)
    na = len(roots)
    for _ in range(3):
        left = agg == -1
        if not left.any():
            break
        nbr_agg = np.full(n, -1, np.int64)
        ne = np.diff(C.indptr) > 0
        if C.nnz:
            red = np.maximum.reduceat(agg[C.indices], C.indptr[:-1][ne])
            nbr_agg[ne] = red
        join = left & (nbr_agg != -1)
        if not join.any():
            break
        agg[join] = nbr_agg[join]
    left = np.flatnonzero(agg == -1)
    agg[left] = na + np.arange(len(left))
    return _relabel_by_first_row(agg)


def _relabel_by_first_row(agg: np.ndarray) -> np.ndarray:
    """Renumber aggregate ids by FIRST-OCCURRENCE fine-row order. Luby
    root order is a random permutation, which scrambles the coarse
    numbering and destroys the bandedness of P/R/Ac, and with it the
    locality of every gather in their applies (and the DIA eligibility of
    `convert_hierarchy`). Bandwidth-preserving coarse numbering is free."""
    n = len(agg)
    if n == 0:
        return agg
    na = int(agg.max()) + 1
    first = np.full(na, n, np.int64)
    np.minimum.at(first, agg, np.arange(n, dtype=np.int64))
    rank = np.empty(na, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(na)
    return rank[agg]


def _gather_rows(C, rows) -> np.ndarray:
    """Concatenate the column indices of the given CSR rows (vectorized)."""
    deg = (C.indptr[rows + 1] - C.indptr[rows]).astype(np.int64)
    total = int(deg.sum())
    out_start = np.concatenate([[0], np.cumsum(deg)])
    pos = np.arange(total) - np.repeat(out_start[:-1], deg)
    src = np.repeat(C.indptr[rows].astype(np.int64), deg) + pos
    return C.indices[src]


def _aggregate(C, strategy: str, seed: int) -> np.ndarray:
    """Pick the aggregation pass: sequential greedy (Vanek parity — the
    reference default) when the native C++ sweep is available, else greedy
    for small setups and vectorized PMIS at scale (the reference similarly
    keeps Greedy and PMIS as selectable strategies,
    smoothed_amg.hpp SetCoarseningStrategy)."""
    if strategy == "auto":
        from ... import native

        fast_greedy = native.available() or C.shape[0] <= 5000
        strategy = "greedy" if fast_greedy else "pmis"
    if strategy == "greedy":
        return greedy_aggregate(C)
    if strategy == "pmis-device":
        # the whole Luby/knockout/join loop on the accelerator (the
        # hip_rsamg-analog setup path) — see aggregation_device.py
        from .aggregation_device import pmis_aggregate_jit

        return pmis_aggregate_jit(C, seed)
    return pmis_aggregate(C, seed)


def tentative_prolongation(agg: np.ndarray, n_agg: int, dtype):
    import scipy.sparse as sp

    n = len(agg)
    return sp.csr_matrix(
        (np.ones(n, dtype), (np.arange(n), agg)), shape=(n, n_agg)
    )


def sa_level(A: CSR, *, eps: float = 0.08, omega: float = 2.0 / 3.0,
             strategy: str = "auto", lumping: bool = True,
             seed: int = 0) -> Tuple[CSR, CSR, CSR]:
    """One smoothed-aggregation coarsening step: returns (P, R, Ac)
    (reference: SAAMG::Aggregate_ — AMGSmoothedAggregation).

    Setup-path layout (profiled at 2.1M unknowns): the strength mask is
    computed ONCE over the CSR-ordered entries and reused for both the
    aggregation graph and the filtered operator (no pattern-membership
    re-query), and M = I - ω D⁻¹ A_f is assembled directly on A_f's CSR
    arrays (no scipy eye/diags/subtract passes). When the native layer is
    available the WHOLE level build runs in one fused C++ call —
    strength graph, aggregation, P assembly and the (R·A)·P Galerkin
    product (the reference's device rsamg/csrgemm analog,
    hip_matrix_csr.cpp MatMatMult) — ~4× the scipy formulation on this
    host."""
    import scipy.sparse as sp

    native_out = _sa_level_native(A, eps, omega, strategy, lumping, seed)
    if native_out is not None:
        return native_out

    S = _scipy(A)
    n = S.shape[0]
    data, indices = S.data, S.indices
    indptr = S.indptr.astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=indices.dtype), np.diff(indptr))
    d_abs = np.abs(S.diagonal())

    offd = rows != indices
    strong = offd & (np.abs(data)
                     >= eps * np.sqrt(d_abs[rows] * d_abs[indices]))
    C = sp.csr_matrix(
        (np.ones(int(strong.sum()), np.int8),
         (rows[strong], indices[strong])), shape=S.shape)
    agg = _aggregate(C, strategy, seed)
    n_agg = int(agg.max()) + 1
    Ph = tentative_prolongation(agg, n_agg, S.dtype)

    # filtered operator: strong off-diagonal entries + (lumped) diagonal.
    # CSR entry order is preserved by boolean filtering, so A_f's CSR
    # arrays come straight from the mask — no COO round-trip.
    keep = ~offd | strong
    if int((~offd).sum()) < n:
        # a row without a stored diagonal has no slot for the identity
        # entry of M = I - ω D⁻¹ A_f: take the general scipy path
        return _sa_level_generic(S, strong, agg, n_agg, Ph, omega, lumping,
                                 rows, indices, data)
    af_data = data[keep].copy()
    af_cols = indices[keep]
    af_rows = rows[keep]
    af_ptr = np.concatenate((
        [0], np.cumsum(np.bincount(af_rows, minlength=n))))
    diag_pos = np.flatnonzero(af_rows == af_cols)
    if lumping and (~keep).any():
        lump = np.bincount(rows[~keep], weights=data[~keep], minlength=n)
        # rows lacking an explicit diagonal cannot absorb their lump —
        # only adjust the stored diagonals (reference lumps into a_ii too)
        af_data[diag_pos] += lump[af_rows[diag_pos]]

    dvals = np.zeros(n, af_data.dtype)
    dvals[af_rows[diag_pos]] = af_data[diag_pos]
    inv_d = np.where(dvals != 0, 1.0 / np.where(dvals == 0, 1.0, dvals),
                     1.0)
    # M = I - ω D⁻¹ A_f on A_f's own arrays (pattern unchanged: A_f always
    # contains the stored diagonal entries)
    m_data = -omega * inv_d[af_rows] * af_data
    m_data[diag_pos] += 1.0
    from ...ops.spgemm import spmm_host

    M = sp.csr_matrix((m_data, af_cols, af_ptr), shape=S.shape)
    P = spmm_host(M, Ph)
    R = P.T.tocsr()
    Ac = spmm_host(spmm_host(R, S), P)
    return _to_csr(P), _to_csr(R), _to_csr(Ac)


def _sa_level_native(A, eps, omega, strategy, lumping, seed):
    """Fused native SA level build; returns None when not applicable
    (native layer missing, complex values, empty matrix)."""
    from ... import native

    if not native.available() or A.shape[0] == 0:
        return None
    data = get_host(A, "data")
    if np.issubdtype(data.dtype, np.complexfloating):
        return None
    ptr = get_host(A, "indptr")
    ind = get_host(A, "indices")
    sptr, scol = native.strength_graph(ptr, ind, data, eps)
    if strategy == "auto" or strategy == "greedy":
        agg = native.greedy_aggregate(sptr, scol)
    else:
        import scipy.sparse as sp

        C = sp.csr_matrix(
            (np.ones(len(scol), np.int8), scol, sptr), shape=A.shape)
        agg = _aggregate(C, strategy, seed)
    n_agg = int(agg.max()) + 1
    P, R, Ac = native.sa_galerkin(ptr, ind, data, agg, n_agg, eps, omega,
                                  lumping)
    n = A.shape[0]
    dt = data.dtype

    def wrap(tri, shape):
        p, c, v = tri
        if v.dtype != dt:
            v = v.astype(dt)
        return CSR.from_arrays(v, c, p, shape, device=False)

    return (wrap(P, (n, n_agg)), wrap(R, (n_agg, n)),
            wrap(Ac, (n_agg, n_agg)))


def _sa_level_generic(S, strong, agg, n_agg, Ph, omega, lumping,
                      rows, indices, data):
    """SA fallback for matrices with rows lacking a stored diagonal
    (generic scipy assembly — the original formulation)."""
    import scipy.sparse as sp

    offd = rows != indices
    keep = ~offd | strong
    Af = sp.csr_matrix((data[keep], (rows[keep], indices[keep])),
                       shape=S.shape)
    if lumping and (~keep).any():
        lump = np.bincount(rows[~keep], weights=data[~keep],
                           minlength=S.shape[0])
        Af = Af + sp.diags(lump)
    d = Af.diagonal()
    inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
    from ...ops.spgemm import spmm_host

    P = ((sp.eye(S.shape[0], format="csr")
          - omega * sp.diags(inv_d) @ Af) @ Ph).tocsr()
    R = P.T.tocsr()
    Ac = spmm_host(spmm_host(R, S), P)
    return _to_csr(P), _to_csr(R), _to_csr(Ac)


def ua_level(A: CSR, *, eps: float = 0.08, over_interp: float = 1.0,
             strategy: str = "auto", seed: int = 0):
    """One unsmoothed-aggregation step (reference: UAAMG::Aggregate_ with
    SetOverInterp — coarse operator scaled by 1/over_interp)."""
    S = _scipy(A)
    C = strength_connect(S, eps)
    agg = _aggregate(C, strategy, seed)
    n_agg = int(agg.max()) + 1
    from ...ops.spgemm import spmm_host

    P = tentative_prolongation(agg, n_agg, S.dtype).tocsr()
    R = P.T.tocsr()
    Ac = spmm_host(spmm_host(R, S), P)
    if over_interp != 1.0:
        Ac = Ac * (1.0 / over_interp)
    return _to_csr(P), _to_csr(R), _to_csr(Ac)


def pairwise_level(A: CSR, *, beta: float = 0.25, npass: int = 2,
                   seed: int = 0):
    """Notay pairwise aggregation: `npass` rounds of greedy strongest-
    negative-coupling matching (reference: PairwiseAMG, SetBeta /
    SetCoarseningFactor ~ 2^npass)."""
    import scipy.sparse as sp

    S = _scipy(A)
    n = S.shape[0]
    agg = np.arange(n)
    cur = S
    from ... import native

    for _ in range(npass):
        m = cur.shape[0]
        indptr, indices, data = cur.indptr, cur.indices, cur.data
        order = np.argsort(np.diff(indptr),
                           kind="stable")   # fewest neighbors first
        if native.available():
            # the matching sweep is sequential (each pairing blocks its
            # partner) -> native C++ layer, like greedy aggregation
            new_id, na = native.pairwise_match(
                indptr, indices, data.astype(np.float64), beta, order
            )
        else:
            # match each unpaired node with its strongest negative neighbor
            neg_min = np.zeros(m)
            for i in range(m):
                sl = slice(indptr[i], indptr[i + 1])
                offs = indices[sl] != i
                if offs.any():
                    neg_min[i] = min(data[sl][offs].min(), 0.0)
            new_id = np.full(m, -1, np.int64)
            na = 0
            for i in order:
                if new_id[i] != -1:
                    continue
                sl = slice(indptr[i], indptr[i + 1])
                cols, vals = indices[sl], data[sl]
                mask = (cols != i) & (new_id[cols] == -1) & (
                    vals <= beta * neg_min[i]
                ) & (vals < 0)
                if mask.any():
                    j = cols[mask][np.argmin(vals[mask])]
                    new_id[i] = na
                    new_id[j] = na
                else:
                    new_id[i] = na
                na += 1
        agg = new_id[agg]
        Pl = sp.csr_matrix(
            (np.ones(m, S.dtype), (np.arange(m), new_id)), shape=(m, na)
        )
        cur = (Pl.T @ cur @ Pl).tocsr()
    n_agg = int(agg.max()) + 1
    from ...ops.spgemm import spmm_host

    P = tentative_prolongation(agg, n_agg, S.dtype).tocsr()
    R = P.T.tocsr()
    Ac = spmm_host(spmm_host(R, S), P)
    return _to_csr(P), _to_csr(R), _to_csr(Ac)


def _to_csr(S) -> CSR:
    # scipy output is already CSR — wrap its arrays directly (a COO
    # round-trip would re-sort every entry).
    # device=False: these are setup intermediates; build_hierarchy uploads
    # the levels the hierarchy keeps.
    S = S.tocsr()
    S.sort_indices()
    return CSR.from_arrays(S.data, S.indices, S.indptr, S.shape,
                           device=False)
