"""CSR storage format.

Reference parity: `MatrixCSR` struct (src/base/matrix_formats.hpp:51-66) and
`HostMatrixCSR` / `HIPAcceleratorMatrixCSR` op surface. One addition: we
carry `row_ids` (the COO-expanded row index of every nonzero) so
SpMV lowers to a vectorized multiply + `segment_sum` — the natural XLA
formulation — without per-call recomputation, and CSR ops never loop over rows
in Python.
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
class CSR(MatrixBase):
    data: jnp.ndarray        # (nnz,) values
    indices: jnp.ndarray     # (nnz,) column indices, int32
    indptr: jnp.ndarray      # (nrow+1,) row pointers, int32
    row_ids: jnp.ndarray     # (nnz,) row index of each nonzero, int32
    shape: Tuple[int, int] = static_field(default=(0, 0))

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @staticmethod
    def from_arrays(data, indices, indptr, shape, device: bool = True) -> "CSR":
        """Build from classic CSR triplet; computes row_ids once (host or
        traced). ``device=False`` keeps the leaves as HOST numpy arrays —
        for setup-phase intermediates (AMG coarsening products, factors
        that only the host analysis reads); `formats.base.on_device`
        uploads the ones a solver keeps."""
        nnz = int(np.asarray(data.shape)[0]) if hasattr(data, "shape") else len(data)
        nrow = int(shape[0])
        host_side = isinstance(indptr, np.ndarray) or not hasattr(indptr, "aval")
        if host_side:
            ip = np.asarray(indptr, dtype=np.int64)
            row_ids_np = np.repeat(np.arange(nrow, dtype=np.int32), np.diff(ip))
            put = (jnp.asarray if device else np.asarray)
            row_ids = put(row_ids_np)
        else:
            put = jnp.asarray
            counts = jnp.diff(indptr)
            row_ids = jnp.repeat(
                jnp.arange(nrow, dtype=jnp.int32), counts, total_repeat_length=nnz
            )
        if host_side:
            out = CSR(
                data=put(data),
                indices=put(np.asarray(indices, dtype=np.int32)),
                indptr=put(np.asarray(indptr, dtype=np.int32)),
                row_ids=row_ids,
                shape=(int(shape[0]), int(shape[1])),
            )
        else:
            out = CSR(
                data=jnp.asarray(data),
                indices=jnp.asarray(indices, dtype=jnp.int32),
                indptr=jnp.asarray(indptr, dtype=jnp.int32),
                row_ids=row_ids,
                shape=(int(shape[0]), int(shape[1])),
            )
        if host_side:
            # cache arrays in their NATIVE dtypes (no astype copies):
            # every consumer either astypes on access (numpy_triplet,
            # numpy_rows) or is dtype-agnostic; eager int64 copies would
            # cost seconds per AMG level at millions of unknowns.
            set_host_cache(
                out,
                data=np.asarray(data),
                indices=np.asarray(indices),
                indptr=ip,
                row_ids=row_ids_np,
            )
        return out

    @staticmethod
    def from_coo(rows, cols, vals, shape, sum_duplicates: bool = True,
                 device: bool = True) -> "CSR":
        """Host-side build from COO triplets (sorts by (row, col)).
        ``device=False`` keeps leaves host-resident (see from_arrays)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and len(rows) > 0:
            keep = np.ones(len(rows), dtype=bool)
            same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
            if same.any():
                # accumulate duplicate entries
                group = np.concatenate([[0], np.cumsum(~same)])
                out_vals = np.zeros(group[-1] + 1, dtype=vals.dtype)
                np.add.at(out_vals, group, vals)
                first = np.concatenate([[True], ~same])
                rows, cols, vals = rows[first], cols[first], out_vals
        nrow = int(shape[0])
        indptr = np.zeros(nrow + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return CSR.from_arrays(vals, cols, indptr, shape, device=device)

    @staticmethod
    def from_dense(dense) -> "CSR":
        d = np.asarray(dense)
        rows, cols = np.nonzero(d)
        return CSR.from_coo(rows, cols, d[rows, cols], d.shape)

    def to_dense(self) -> jnp.ndarray:
        out = jnp.zeros(self.shape, dtype=self.data.dtype)
        return out.at[self.row_ids, self.indices].add(self.data)

    def transpose_host(self, device: bool = True) -> "CSR":
        """Host-side transpose (setup phase; analog LocalMatrix::Transpose)."""
        rows = get_host(self, "row_ids")
        cols = get_host(self, "indices")
        vals = get_host(self, "data")
        return CSR.from_coo(cols, rows, vals, (self.shape[1], self.shape[0]),
                            device=device)

    def numpy_triplet(self):
        """Host CSR triplet; uses the host cache (no device read if built on
        host — see base.set_host_cache)."""
        return (
            get_host(self, "data"),
            get_host(self, "indices").astype(np.int64),
            get_host(self, "indptr").astype(np.int64),
        )

    def numpy_rows(self):
        return get_host(self, "row_ids").astype(np.int64)
