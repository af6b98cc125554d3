"""Block preconditioners: BlockJacobi, BlockPreconditioner, (R)AS.

Reference parity:
- BlockJacobi (preconditioner_blockjacobi.{hpp,cpp}) — per-block local
  preconditioning; the reference's Global workhorse (the distributed variant
  lives in rocalution_tpu.parallel.block_jacobi_diag).
- BlockPreconditioner (preconditioner_blockprecond.{hpp,cpp}) —
  block-diagonal or block-lower-triangular composition of per-block
  sub-solvers (SetDiagonalSolver/SetLSolver).
- AS/RAS (preconditioner_as.{hpp,cpp}) — (restricted) additive Schwarz with
  `Set(num_blocks, overlap, ...)`; AS recombines overlap with 1/2 weights
  (preconditioner_as.hpp:34-114), RAS keeps only the owner's interior.

Design: uniform diagonal blocks are stored as one (nb, bs, bs)
stack and inverted once at setup; every apply is then a single batched
matmul (at `Precision.HIGHEST`, never TF32) — no per-block loops on device.
Schwarz overlap gather/scatter are static index arrays.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import CSR, to_csr
from ..formats.base import get_host
from ..ops.extract import extract_index_submatrix, extract_submatrix
from ..ops.spmv import spmv


def _dense_blocks(A: CSR, offsets: np.ndarray, padded: int) -> np.ndarray:
    """Gather the diagonal blocks of A into an (nb, padded, padded) stack
    (pad with identity so the batched inverse stays well-defined)."""
    import scipy.sparse as sp

    S = sp.csr_matrix(
        (get_host(A, "data"), get_host(A, "indices").astype(np.int64),
         get_host(A, "indptr").astype(np.int64)), shape=A.shape,
    )
    nb = len(offsets) - 1
    out = np.tile(np.eye(padded, dtype=S.dtype), (nb, 1, 1))
    for k in range(nb):
        s, e = offsets[k], offsets[k + 1]
        out[k, : e - s, : e - s] = S[s:e, s:e].toarray()
    return out


def block_jacobi(A, num_blocks: int = 8):
    """BlockJacobi: z_k = (A_kk)^{-1} r_k per contiguous diagonal block.

    Setup inverts the (nb, bs, bs) block stack once; apply = one batched
    matmul (reference: BlockJacobi with a direct local solver).
    """
    csr = A if isinstance(A, CSR) else to_csr(A)
    n = csr.shape[0]
    bs = -(-n // num_blocks)
    offsets = np.minimum(np.arange(num_blocks + 1) * bs, n)
    blocks = _dense_blocks(csr, offsets, bs)
    inv = jnp.asarray(np.linalg.inv(blocks))     # (nb, bs, bs), host setup
    pad = num_blocks * bs - n

    def apply(r):
        rp = jnp.pad(r, (0, pad)) if pad else r
        rb = rp.reshape(num_blocks, bs)
        zb = jnp.einsum("kij,kj->ki", inv, rb,
                        precision=jax.lax.Precision.HIGHEST)
        return zb.reshape(-1)[:n]

    return apply


def block_precond(A, num_blocks: int, solvers: Sequence[Callable],
                  *, lower: bool = False):
    """BlockPreconditioner: block-diagonal (default) or block-lower-
    triangular composition of per-block preconditioner closures
    (reference: BlockPreconditioner SetDiagonalSolver / SetLSolver).

    `solvers[k]` is a closure r_k -> z_k for diagonal block k.
    """
    csr = A if isinstance(A, CSR) else to_csr(A)
    n = csr.shape[0]
    sizes = [n // num_blocks + (1 if i < n % num_blocks else 0)
             for i in range(num_blocks)]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    off_blocks = {}
    if lower:
        for i in range(num_blocks):
            for j in range(i):
                off_blocks[(i, j)] = extract_submatrix(
                    csr, offs[i], offs[j], sizes[i], sizes[j]
                )

    def apply(r):
        zs: List[jnp.ndarray] = []
        for i in range(num_blocks):
            ri = r[offs[i]:offs[i + 1]]
            if lower:
                for j in range(i):
                    ri = ri - spmv(off_blocks[(i, j)], zs[j])
            zs.append(solvers[i](ri))
        return jnp.concatenate(zs)

    return apply


def additive_schwarz(A, num_blocks: int = 4, overlap: int = 4,
                     inner: Optional[Callable] = None, *,
                     restricted: bool = False):
    """AS/RAS: overlapping diagonal blocks, per-block solve, weighted
    recombination (reference: AS/RAS Set(nb, overlap, preconds)).

    `inner(block_csr) -> closure` builds the per-block solver (default:
    dense inverse, batched). `restricted=True` gives RAS.
    """
    csr = A if isinstance(A, CSR) else to_csr(A)
    n = csr.shape[0]
    bs = -(-n // num_blocks)
    ext = []
    for k in range(num_blocks):
        s = max(0, k * bs - overlap)
        e = min(n, (k + 1) * bs + overlap)
        ext.append((s, e))
    width = max(e - s for s, e in ext)

    if inner is None:
        # batched dense inverses, identity-padded
        blocks = np.stack([
            np.eye(width, dtype=np.asarray(get_host(csr, "data")).dtype)
            for _ in range(num_blocks)
        ])
        for k, (s, e) in enumerate(ext):
            blocks[k][: e - s, : e - s] = np.asarray(
                extract_submatrix(csr, s, s, e - s, e - s).to_dense()
            )
        inv = jnp.asarray(np.linalg.inv(blocks))

        def block_solve(k, rk):  # rk padded to width
            return jnp.matmul(inv[k], rk,
                              precision=jax.lax.Precision.HIGHEST)

        solvers = [lambda rk, k=k: block_solve(k, rk)
                   for k in range(num_blocks)]
    else:
        sub = [extract_submatrix(csr, s, s, e - s, e - s) for s, e in ext]
        inner_closures = [inner(m) for m in sub]

        def make(k):
            s, e = ext[k]
            clos = inner_closures[k]

            def f(rk):
                return jnp.pad(clos(rk[: e - s]), (0, width - (e - s)))
            return f

        solvers = [make(k) for k in range(num_blocks)]

    # recombination weights: RAS keeps only the owner interior; AS halves
    # the overlapped entries (reference: 1/2-scaled overlap recombination)
    weights = np.zeros((num_blocks, width))
    counts = np.zeros(n)
    for k, (s, e) in enumerate(ext):
        counts[s:e] += 1
    for k, (s, e) in enumerate(ext):
        if restricted:
            own_s, own_e = k * bs, min((k + 1) * bs, n)
            w = np.zeros(e - s)
            w[own_s - s: own_e - s] = 1.0
        else:
            w = 1.0 / counts[s:e]
        weights[k, : e - s] = w
    weights_j = jnp.asarray(weights)
    idx = np.zeros((num_blocks, width), dtype=np.int64)
    for k, (s, e) in enumerate(ext):
        idx[k, : e - s] = np.arange(s, e)
        idx[k, e - s:] = n  # scatter pad to scratch slot
    idx_j = jnp.asarray(idx)

    def apply(r):
        z = jnp.zeros((n + 1,), r.dtype)
        for k, (s, e) in enumerate(ext):
            rk = jax.lax.dynamic_slice(
                jnp.pad(r, (0, width)), (s,), (width,)
            )
            rk = jnp.where(jnp.arange(width) < (e - s), rk, 0.0)
            zk = solvers[k](rk)
            z = z.at[idx_j[k]].add(weights_j[k] * zk)
        return z[:n]

    return apply


def restricted_additive_schwarz(A, num_blocks: int = 4, overlap: int = 4,
                                inner: Optional[Callable] = None):
    """RAS (reference: preconditioner_as.hpp RAS variant)."""
    return additive_schwarz(A, num_blocks, overlap, inner, restricted=True)
