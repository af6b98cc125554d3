"""Standalone distributed matrix operations (setup phase).

Reference parity: GlobalMatrix::Transpose and
GlobalMatrix::TripleMatrixProduct as PUBLIC ops
(src/base/global_matrix.hpp:212-219) — previously these existed only
fused inside the distributed AMG setup sweep (parallel/amg_setup.py).

Placement: like every SpGEMM-class operation in this package these are
host-side, per-part-block sweeps with explicit exchanges (the
CommunicateCSRAsync_ analog) — output sparsity is data-dependent, which
is setup-phase work under XLA's static-shape model (SURVEY.md §7). The
inputs/outputs are GlobalCSR pytrees; each GlobalCSR built by
`global_csr_from_blocks`/`distribute_csr` carries a host block cache, so
no device read-back ever happens.
"""

from __future__ import annotations

import numpy as np

from .partition import GlobalCSR, global_csr_from_blocks


def _block_cache(Ag: GlobalCSR):
    cache = getattr(Ag, "_block_cache", None)
    if cache is None:
        raise ValueError(
            "GlobalCSR carries no host block cache (built on device?): "
            "distributed Transpose/TripleMatrixProduct are setup-phase "
            "host ops — construct the operand via distribute_csr / "
            "global_csr_from_blocks")
    return cache              # (list of scipy CSR (nl_p, ncol_global), offs)


def _blocks_of(mats):
    out = []
    for m in mats:
        coo = m.tocoo()
        out.append((coo.row.astype(np.int64), coo.col.astype(np.int64),
                    coo.data))
    return out


def _transpose_exchange(mats, offs, col_offs):
    """Bucket every entry to the owner of its column under `col_offs`
    (the inverse boundary-row CSR exchange, global_matrix.cpp:4041-4311):
    returns per-part blocks of the TRANSPOSE on the `col_offs` row
    partition."""
    import scipy.sparse as sp

    Pn = len(col_offs) - 1
    N = int(offs[-1])
    sends = [[] for _ in range(Pn)]
    for p, m in enumerate(mats):
        coo = m.tocoo()
        dest = np.searchsorted(col_offs, coo.col, side="right") - 1
        for q in np.unique(dest):
            sel = dest == q
            sends[q].append((coo.col[sel] - col_offs[q],
                             coo.row[sel] + offs[p], coo.data[sel]))
    out = []
    dt = mats[0].dtype.type if mats else np.float64
    for q in range(Pn):
        nr_q = int(col_offs[q + 1] - col_offs[q])
        if sends[q]:
            rr = np.concatenate([s[0] for s in sends[q]])
            rc = np.concatenate([s[1] for s in sends[q]])
            rd = np.concatenate([s[2] for s in sends[q]])
        else:
            rr = rc = np.zeros(0, np.int64)
            rd = np.zeros(0, dt)
        out.append(sp.csr_matrix((rd, (rr, rc)), shape=(nr_q, N)))
    return out


def global_transpose(Ag: GlobalCSR) -> GlobalCSR:
    """A^T of a distributed operator (reference: GlobalMatrix::Transpose,
    global_matrix.hpp:212). Rows of the result follow the EQUAL partition
    of A's columns."""
    from .amg_setup import _offsets

    mats, offs = _block_cache(Ag)
    ncol = Ag.n_global_col or Ag.n_global
    col_offs = _offsets(Ag.nparts, ncol)
    t_mats = _transpose_exchange(mats, offs, col_offs)
    return global_csr_from_blocks(
        _blocks_of(t_mats), (ncol, int(offs[-1])))


def global_triple_product(Rg: GlobalCSR, Ag: GlobalCSR, Pg: GlobalCSR
                          ) -> GlobalCSR:
    """R·A·P of distributed operators (reference:
    GlobalMatrix::TripleMatrixProduct, global_matrix.hpp:219): AP with
    owner-fetched ghost rows of P, then R·(AP) with owner-fetched rows —
    the same exchange pattern the distributed AMG setup uses, exposed as
    a standalone op."""
    from .amg_setup import _fetch_rows

    R_mats, r_offs = _block_cache(Rg)
    A_mats, a_offs = _block_cache(Ag)
    P_mats, p_offs = _block_cache(Pg)
    NC = Pg.n_global_col or Pg.n_global

    AP = []
    for p, m in enumerate(A_mats):
        Pfull = _fetch_rows(P_mats, p_offs, np.unique(m.tocoo().col), NC)
        AP.append((m @ Pfull).tocsr())

    out = []
    for q, Rq in enumerate(R_mats):
        cols = np.unique(Rq.tocoo().col)
        APfull = _fetch_rows(AP, a_offs, cols, NC)
        out.append((Rq @ APfull).tocsr())
    NR = int(r_offs[-1])
    return global_csr_from_blocks(_blocks_of(out), (NR, NC))
