"""DIA storage format (reference: MatrixDIA struct, matrix_formats.hpp:121-130).

DIA suits banded/stencil matrices: SpMV is gather-free (static shifted
multiplies that XLA fuses into one elementwise pass). Offsets are static
metadata so the diagonal loop fully unrolls at
trace time.
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
class DIA(MatrixBase):
    data: jnp.ndarray                 # (ndiag, nrow); data[d, i] = A[i, i + off[d]]
    offsets: Tuple[int, ...] = static_field(default=())  # static diagonal offsets
    shape: Tuple[int, int] = static_field(default=(0, 0))

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        """True nonzero count (explicit zeros in the band are not counted)."""
        return int(np.count_nonzero(get_host(self, "data")))

    @property
    def nnz_stored(self) -> int:
        """Band-footprint element count (what DIA actually stores/streams)."""
        n, m = self.shape
        total = 0
        for off in self.offsets:
            total += max(0, min(n, m - off) - max(0, -off))
        return total

    @staticmethod
    def from_csr_host(csr) -> "DIA":
        data, indices, indptr = csr.numpy_triplet()
        nrow, ncol = csr.shape
        counts = np.diff(indptr)
        rows = np.repeat(np.arange(nrow, dtype=np.int64), counts)
        offs = indices - rows
        uniq = np.unique(offs)
        dia = np.zeros((len(uniq), nrow), dtype=data.dtype)
        d_idx = np.searchsorted(uniq, offs)
        dia[d_idx, rows] = data
        out = DIA(
            data=jnp.asarray(dia),
            offsets=tuple(int(o) for o in uniq),
            shape=(nrow, ncol),
        )
        set_host_cache(out, data=dia)
        return out

    def to_dense(self) -> jnp.ndarray:
        n, m = self.shape
        out = jnp.zeros((n, m), dtype=self.data.dtype)
        rows = jnp.arange(n, dtype=jnp.int32)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            valid = (cols >= 0) & (cols < m)
            out = out.at[rows, jnp.clip(cols, 0, m - 1)].add(
                jnp.where(valid, self.data[d], 0)
            )
        return out
