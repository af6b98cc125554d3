"""Distributed BlockJacobi preconditioning with LOCAL sub-preconditioners.

Reference parity: the MPI samples precondition global Krylov solvers with
``BlockJacobi<GlobalMatrix, LocalMatrix>`` wrapping a local solver on each
rank's diagonal block — SPAI (fgmres_mpi.cpp), FSAI (idr_mpi.cpp,
global-io_mpi.cpp), ILU (fcg_mpi.cpp), ILUT (qmrcgstab_mpi.cpp); see
preconditioner_blockjacobi.hpp:34-45.

Formulation: each part's diagonal block gets its local preconditioner
built host-side at setup; the per-block operators are STACKED with a
leading (P,) axis and applied inside `shard_map` with the same SPMD
program on every shard (COO segment-sum applies / Jacobi tri-sweeps —
block-local work only, no communication, exactly like the reference's
BlockJacobi which never touches ghost columns).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import numpy as np

from ..formats import CSR
from .partition import GlobalCSR, shard_stacked


@dataclasses.dataclass(frozen=True)
class ShardPrecond:
    """A preconditioner applied per shard inside `shard_map`.

    `arrays` is a pytree whose every leaf carries a leading (P,) axis
    (sharded over the mesh axis by dist_solve); `kind`/`sweeps` are static
    and select the apply program (identical on every shard — SPMD-safe).
    """

    arrays: Tuple[Any, ...]
    kind: str          # "spmv1" | "spmv2" | "sweeps"
    sweeps: int = 8

    def shard_apply(self, arrs, r):
        """z = M^{-1} r for one shard; `arrs` = self.arrays with the
        leading axis stripped."""
        if self.kind == "spmv1":           # SPAI: one local SpMV
            rows, cols, data = arrs
            return _coo_apply(rows, cols, data, r)
        if self.kind == "spmv2":           # FSAI: z = G^T (G r)
            gr, gc, gd, tr, tc, td = arrs
            return _coo_apply(tr, tc, td, _coo_apply(gr, gc, gd, r))
        if self.kind == "sweeps":          # ILU/ILUT: L then U tri-sweeps
            (lr, lc, ld, ur, uc, ud, invd) = arrs
            y = _jacobi_sweeps(lr, lc, ld, None, r, self.sweeps)
            return _jacobi_sweeps(ur, uc, ud, invd, y, self.sweeps)
        raise ValueError(f"unknown ShardPrecond kind {self.kind!r}")


def _coo_apply(rows, cols, data, r):
    return jax.ops.segment_sum(data * r[cols], rows,
                               num_segments=r.shape[0])


def _jacobi_sweeps(rows, cols, data, invd, b, sweeps):
    """x_{k+1} = D^{-1}(b - N x_k) with N strictly-triangular (COO);
    invd=None means unit diagonal (trisolve_jacobi semantics)."""
    def scale(v):
        return v if invd is None else invd * v

    x = scale(b)

    def body(_, x):
        return scale(b - _coo_apply(rows, cols, data, x))

    return jax.lax.fori_loop(0, sweeps, body, x)


def _local_blocks(A: GlobalCSR):
    """Per-part diagonal-block CSRs recovered from the stacked interior
    arrays. Valid entries come from the per-part nnz counts recorded at
    distribute time (A.int_nnz) so genuinely stored zeros — including an
    exactly-zero diagonal — keep their place in the ILU0/SPAI pattern;
    only when the counts are absent (legacy pickles) fall back to a
    data != 0 mask."""
    data = np.asarray(A.int_data)
    rows = np.asarray(A.int_rows)
    cols = np.asarray(A.int_cols)
    nl = A.n_local
    out = []
    for p in range(A.nparts):
        if A.int_nnz:
            k = A.int_nnz[p]
            rp, cp, dp = rows[p][:k], cols[p][:k], data[p][:k]
        else:
            m = data[p] != 0
            rp, cp, dp = rows[p][m], cols[p][m], data[p][m]
        out.append(CSR.from_coo(rp, cp, dp, (nl, nl)))
    return out


def _stack_coo(mats, nnz=None):
    """Stack local CSRs into (P, nnz_max) COO triplets (zero-padded)."""
    trips = []
    for Mk in mats:
        d, c, _ = Mk.numpy_triplet()
        r = Mk.numpy_rows()
        trips.append((r, c, d))
    mx = max(1, max(len(t[0]) for t in trips)) if nnz is None else nnz
    P = len(trips)
    # dtype from the first NON-EMPTY triplet: an empty first block must not
    # upcast the whole stacked preconditioner to f64 (advisor r3)
    dt = next((t[2].dtype for t in trips if len(t[2])), np.float64)
    R = np.zeros((P, mx), np.int32)
    C = np.zeros((P, mx), np.int32)
    D = np.zeros((P, mx), dt)
    for p, (r, c, d) in enumerate(trips):
        k = len(r)
        R[p, :k], C[p, :k], D[p, :k] = r, c, d
    return shard_stacked((R, C, D))


def block_jacobi_precond(A: GlobalCSR, kind: str = "spai", *,
                         sweeps: int = 8, **kw) -> ShardPrecond:
    """Build a BlockJacobi preconditioner with a LOCAL sub-preconditioner
    per diagonal block (reference: preconditioner_blockjacobi.hpp used by
    every preconditioned MPI sample).

    kind: "spai" | "fsai" | "ilu0" | "ilut" (reference local solvers of
    fgmres_mpi / idr_mpi / fcg_mpi / qmrcgstab_mpi respectively).
    """
    blocks = _local_blocks(A)
    if kind == "spai":
        from ..precond.ai import spai_matrix

        return ShardPrecond(_stack_coo([spai_matrix(B) for B in blocks]),
                            "spmv1")
    if kind == "fsai":
        from ..precond.ai import fsai_matrices

        gs, gts = zip(*(fsai_matrices(B, kw.get("q", 1)) for B in blocks))
        return ShardPrecond(_stack_coo(gs) + _stack_coo(gts), "spmv2")
    if kind in ("ilu0", "ilut"):
        from ..ops.factorize import ilu0, ilut
        from ..ops.extract import extract_lower, extract_upper
        from ..precond.jacobi import extract_diagonal

        Ls, Us, invds = [], [], []
        for B in blocks:
            L, U = (ilu0(B) if kind == "ilu0"
                    else ilut(B, kw.get("tol", 1e-3),
                              kw.get("max_fill", 32)))
            d = np.asarray(extract_diagonal(U))
            invds.append(np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d),
                                  1.0))
            Ls.append(extract_lower(L, diag=False))   # strict lower (unit)
            Us.append(extract_upper(U, diag=False))   # strict upper
        lr, lc, ld = _stack_coo(Ls)
        ur, uc, ud = _stack_coo(Us)
        invd = shard_stacked(np.stack(invds))
        return ShardPrecond((lr, lc, ld, ur, uc, ud, invd), "sweeps",
                            sweeps=sweeps)
    raise ValueError(f"unknown block preconditioner kind {kind!r}")
