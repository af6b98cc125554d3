"""DENSE format (reference: MatrixDENSE, matrix_formats.hpp:149-156).

Used by direct solvers (LU/QR/Inversion) and coarse-grid AMG solves; a plain
row-major array, no special storage tricks.
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
class DENSE(MatrixBase):
    data: jnp.ndarray  # (nrow, ncol)
    shape: Tuple[int, int] = static_field(default=(0, 0))

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    @staticmethod
    def from_array(a) -> "DENSE":
        host = isinstance(a, np.ndarray) or not hasattr(a, "aval")
        aj = jnp.asarray(a)
        out = DENSE(data=aj, shape=(int(aj.shape[0]), int(aj.shape[1])))
        if host:
            set_host_cache(out, data=np.asarray(a))
        return out

    @staticmethod
    def from_csr_host(csr) -> "DENSE":
        data, indices, indptr = csr.numpy_triplet()
        rows = csr.numpy_rows()
        dense = np.zeros(csr.shape, dtype=data.dtype)
        np.add.at(dense, (rows, indices), data)
        return DENSE.from_array(dense)

    def to_dense(self) -> jnp.ndarray:
        return self.data
