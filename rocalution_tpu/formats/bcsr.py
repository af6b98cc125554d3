"""BCSR storage format (reference: MatrixBCSR, matrix_formats.hpp:83-104).

SpMV batches all block×vector products into one `dot_general` over the
dense blocks (at `Precision.HIGHEST`, see ops/spmv.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .base import (MatrixBase, get_host, register_format, set_host_cache,
                   static_field)


@register_format
@dataclasses.dataclass(frozen=True)
class BCSR(MatrixBase):
    data: jnp.ndarray      # (nnzb, br, bc) dense blocks
    indices: jnp.ndarray   # (nnzb,) block-column indices, int32
    indptr: jnp.ndarray    # (nrowb+1,) int32
    row_ids: jnp.ndarray   # (nnzb,) block-row id of each block, int32
    block_dim: int = static_field(default=1)
    shape: Tuple[int, int] = static_field(default=(0, 0))  # scalar shape (padded)

    @property
    def nrowb(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def nnzb(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(get_host(self, "data")))

    @staticmethod
    def from_csr_host(csr, block_dim: int) -> "BCSR":
        data, indices, indptr = csr.numpy_triplet()
        nrow, ncol = csr.shape
        bd = int(block_dim)
        nrowb = -(-nrow // bd)
        ncolb = -(-ncol // bd)
        rows = np.repeat(np.arange(nrow, dtype=np.int64), np.diff(indptr))
        brows = rows // bd
        bcols = indices // bd
        # unique (brow, bcol) pairs define the block pattern
        key = brows * ncolb + bcols
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        uniq_key, first = np.unique(key_s, return_index=True)
        block_of_nnz = np.searchsorted(uniq_key, key)
        nnzb = len(uniq_key)
        blocks = np.zeros((nnzb, bd, bd), dtype=data.dtype)
        np.add.at(blocks, (block_of_nnz, rows % bd, indices % bd), data)
        ub_rows = (uniq_key // ncolb).astype(np.int64)
        ub_cols = (uniq_key % ncolb).astype(np.int32)
        bindptr = np.zeros(nrowb + 1, dtype=np.int64)
        np.add.at(bindptr, ub_rows + 1, 1)
        bindptr = np.cumsum(bindptr)
        out = BCSR(
            data=jnp.asarray(blocks),
            indices=jnp.asarray(ub_cols),
            indptr=jnp.asarray(bindptr, dtype=jnp.int32),
            row_ids=jnp.asarray(ub_rows, dtype=jnp.int32),
            block_dim=bd,
            shape=(nrow, ncol),
        )
        set_host_cache(out, data=blocks, indices=ub_cols, row_ids=ub_rows)
        return out

    def to_dense(self) -> jnp.ndarray:
        bd = self.block_dim
        nrowb = self.nrowb
        ncolb = -(-self.shape[1] // bd)
        big = jnp.zeros((nrowb, ncolb, bd, bd), dtype=self.data.dtype)
        big = big.at[self.row_ids, self.indices].add(self.data)
        dense = big.transpose(0, 2, 1, 3).reshape(nrowb * bd, ncolb * bd)
        return dense[: self.shape[0], : self.shape[1]]
