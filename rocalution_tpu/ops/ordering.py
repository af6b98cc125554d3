"""Matrix orderings / reorderings.

Reference parity: LocalMatrix ordering ops (src/base/local_matrix.hpp:
434-480) — MultiColoring, MaximalIndependentSet, CMK/RCMK,
ConnectivityOrder, ZeroBlockPermutation — plus Permute/PermuteBackward.

Placement: orderings are *setup-phase* graph algorithms computed
once per matrix on the host (the reference likewise runs CMK/RCMK/MIS
host-side only — they are absent from hip_matrix_csr.hpp), producing
permutations and color/level partitions that the device solve phase consumes
as static structure. All routines take/return numpy and operate on the CSR
host cache, never forcing a device read.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..formats import CSR
from ..formats.base import get_host


def _host_csr(A: CSR):
    data = get_host(A, "data")
    indices = get_host(A, "indices").astype(np.int64)
    indptr = get_host(A, "indptr").astype(np.int64)
    return data, indices, indptr


def multicoloring(A: CSR) -> Tuple[int, np.ndarray, np.ndarray]:
    """Greedy graph coloring of the symmetrized sparsity pattern.

    Returns (num_colors, permutation, block_sizes): `permutation[i]` is the
    new index of row i (rows sorted by color), `block_sizes[c]` the number of
    rows of color c (reference: LocalMatrix::MultiColoring,
    local_matrix.hpp:440-448 — same outputs).
    """
    n = A.shape[0]
    G = _sym_graph(A)
    colors = _jp_coloring(G, n)
    ncol = int(colors.max()) + 1 if n else 0
    order = np.argsort(colors, kind="stable")   # old index per new slot
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)                  # new index per old slot
    block_sizes = np.bincount(colors, minlength=ncol)
    return ncol, perm, block_sizes


def _sym_graph(A: CSR):
    import scipy.sparse as sp

    _, indices, indptr = _host_csr(A)
    G = sp.csr_matrix(
        (np.ones(len(indices), np.int8), indices, indptr), shape=A.shape
    )
    G = (G + G.T).tocsr()
    G.setdiag(0)
    G.eliminate_zeros()
    return G


def _neighbor_max(G, vals):
    """Per-row max of vals over the neighbor lists (vectorized reduceat)."""
    n = G.shape[0]
    out = np.full(n, -np.inf)
    nonempty = np.diff(G.indptr) > 0
    if G.nnz:
        red = np.maximum.reduceat(vals[G.indices], G.indptr[:-1][nonempty])
        out[nonempty] = red
    return out


def _jp_coloring(G, n, seed: int = 0) -> np.ndarray:
    """Jones–Plassmann parallel greedy coloring, fully vectorized: each round
    colors the priority-local-maxima of the still-uncolored subgraph — the
    same parallel heuristic family as the reference's device MultiColoring
    kernels (hip_kernels_csr.hpp)."""
    rng = np.random.default_rng(seed)
    w = rng.permutation(n).astype(np.float64)    # unique priorities
    colors = np.full(n, -1, dtype=np.int64)
    active = np.ones(n, dtype=bool)
    c = 0
    wa = w.copy()
    while active.any():
        nbr_max = _neighbor_max(G, np.where(active, wa, -np.inf))
        sel = active & (w > nbr_max)
        colors[sel] = c
        active[sel] = False
        c += 1
    return colors


def maximal_independent_set(A: CSR) -> Tuple[int, np.ndarray]:
    """Greedy maximal independent set decomposition.

    Returns (mis_size, permutation) with MIS rows ordered first (reference:
    LocalMatrix::MaximalIndependentSet, local_matrix.hpp:455-462).
    """
    n = A.shape[0]
    G = _sym_graph(A)
    rng = np.random.default_rng(0)
    w = rng.permutation(n).astype(np.float64)
    in_set = np.zeros(n, dtype=bool)
    candidate = np.ones(n, dtype=bool)
    # Luby's algorithm: rounds of priority-local-maxima join the set and
    # knock out their neighborhood (the parallel formulation the reference
    # uses on-device, hip kernels MIS)
    while candidate.any():
        nbr_max = _neighbor_max(G, np.where(candidate, w, -np.inf))
        sel = candidate & (w > nbr_max)
        in_set |= sel
        candidate[sel] = False
        # remove neighbors of selected nodes (vectorized row-slice gather)
        sel_idx = np.where(sel)[0]
        if len(sel_idx):
            knocked = np.zeros(n, dtype=bool)
            knocked[G[sel_idx].indices] = True
            candidate &= ~knocked
    order = np.concatenate([np.where(in_set)[0], np.where(~in_set)[0]])
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    return int(in_set.sum()), perm


def cmk(A: CSR) -> np.ndarray:
    """Cuthill–McKee bandwidth-reducing permutation (reference:
    LocalMatrix::CMK, local_matrix.hpp:434)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    _, indices, indptr = _host_csr(A)
    G = sp.csr_matrix(
        (np.ones(len(indices), np.int8), indices, indptr), shape=A.shape
    )
    order = reverse_cuthill_mckee(G, symmetric_mode=False)[::-1].copy()
    perm = np.empty(A.shape[0], dtype=np.int64)
    perm[order] = np.arange(A.shape[0])
    return perm


def rcmk(A: CSR) -> np.ndarray:
    """Reverse Cuthill–McKee permutation (reference: LocalMatrix::RCMK)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    _, indices, indptr = _host_csr(A)
    G = sp.csr_matrix(
        (np.ones(len(indices), np.int8), indices, indptr), shape=A.shape
    )
    order = reverse_cuthill_mckee(G, symmetric_mode=False)
    perm = np.empty(A.shape[0], dtype=np.int64)
    perm[order] = np.arange(A.shape[0])
    return perm


def connectivity_order(A: CSR) -> np.ndarray:
    """Order rows by increasing number of nonzeros (reference:
    LocalMatrix::ConnectivityOrder, local_matrix.hpp:471)."""
    _, _, indptr = _host_csr(A)
    deg = np.diff(indptr)
    order = np.argsort(deg, kind="stable")
    perm = np.empty(A.shape[0], dtype=np.int64)
    perm[order] = np.arange(A.shape[0])
    return perm


def zero_block_permutation(A: CSR) -> Tuple[int, np.ndarray]:
    """Permutation placing a maximal set of mutually-independent rows first,
    so the leading diagonal block of the permuted matrix is diagonal
    (reference: LocalMatrix::ZeroBlockPermutation, local_matrix.hpp:478 —
    the MultiElimination building block).

    Returns (block_size, permutation).
    """
    size, perm = maximal_independent_set(A)
    return size, perm


def permute_csr(A: CSR, perm: np.ndarray) -> CSR:
    """Symmetric permutation B = P A P^T: row/col i of A becomes row/col
    perm[i] of B (reference: LocalMatrix::Permute, local_matrix.hpp:496)."""
    data, indices, indptr = _host_csr(A)
    rows = get_host(A, "row_ids").astype(np.int64)
    perm = np.asarray(perm, dtype=np.int64)
    return CSR.from_coo(perm[rows], perm[indices], data, A.shape)


def permute_rows_csr(A: CSR, perm: np.ndarray) -> CSR:
    """Row-only permutation (for non-symmetric reorders)."""
    data, indices, _ = _host_csr(A)
    rows = get_host(A, "row_ids").astype(np.int64)
    perm = np.asarray(perm, dtype=np.int64)
    return CSR.from_coo(perm[rows], indices, data, A.shape)
