"""ELL storage format (reference: MatrixELL struct, matrix_formats.hpp:107-118).

ELL's fixed row width makes SpMV a dense (nrow, width) multiply + row
reduction with a single gather of x. Padding entries store column = -1 and value = 0.
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
class ELL(MatrixBase):
    data: jnp.ndarray     # (nrow, width)
    indices: jnp.ndarray  # (nrow, width) int32, -1 = padding
    shape: Tuple[int, int] = static_field(default=(0, 0))

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def nnz(self) -> int:
        # Reference counts ELL nnz as nrow*width (padded); we report true nnz
        # via the padding mask for bench bookkeeping.
        return int(np.count_nonzero(get_host(self, "indices") >= 0))

    @property
    def nnz_padded(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    @staticmethod
    def from_csr_host(csr, width: int | None = None) -> "ELL":
        data, indices, indptr = csr.numpy_triplet()
        nrow, ncol = csr.shape
        counts = np.diff(indptr)
        w = int(width) if width is not None else (int(counts.max()) if nrow else 0)
        w = max(w, 1)
        ell_data = np.zeros((nrow, w), dtype=data.dtype)
        ell_ind = np.full((nrow, w), -1, dtype=np.int32)
        # vectorized fill: position of each nnz within its row
        pos = np.arange(len(data)) - np.repeat(indptr[:-1], counts)
        rows = np.repeat(np.arange(nrow), counts)
        keep = pos < w
        ell_data[rows[keep], pos[keep]] = data[keep]
        ell_ind[rows[keep], pos[keep]] = indices[keep]
        out = ELL(
            data=jnp.asarray(ell_data),
            indices=jnp.asarray(ell_ind),
            shape=(nrow, ncol),
        )
        set_host_cache(out, data=ell_data, indices=ell_ind)
        return out

    def to_dense(self) -> jnp.ndarray:
        out = jnp.zeros(self.shape, dtype=self.data.dtype)
        rows = jnp.broadcast_to(
            jnp.arange(self.shape[0], dtype=jnp.int32)[:, None], self.indices.shape
        )
        mask = self.indices >= 0
        cols = jnp.where(mask, self.indices, 0)
        vals = jnp.where(mask, self.data, 0)
        return out.at[rows, cols].add(vals)
