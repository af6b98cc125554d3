"""Matrix-free stencil operators.

Reference parity: LocalStencil (src/base/local_stencil.hpp:59+, stencil enum
src/base/stencil_types.hpp:36-39 — Laplace2D is the only type the reference
ships; host kernel src/base/host/host_stencil_laplace2d.cpp).

A stencil is the cheapest operator class to apply: pure shifted adds on a
reshaped grid (no indices at all, less traffic than even DIA), which XLA
fuses into one elementwise pass. We generalize to
arbitrary small stencils (the reference hard-codes the 5-point Laplacian)
and both 2-D and 3-D grids.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .base import MatrixBase, register_format, static_field


@register_format
@dataclasses.dataclass(frozen=True)
class Stencil(MatrixBase):
    """Constant-coefficient stencil on a regular grid.

    `offsets` are grid-coordinate shifts, `weights` the matching
    coefficients; Dirichlet (zero) boundaries, matching the reference's
    Laplace2D stencil semantics.
    """

    weights: jnp.ndarray                                    # (npoints,)
    offsets: Tuple[Tuple[int, ...], ...] = static_field(default=())
    grid: Tuple[int, ...] = static_field(default=())        # grid extents

    @property
    def shape(self) -> Tuple[int, int]:
        n = int(np.prod(self.grid))
        return (n, n)

    @property
    def ndim(self) -> int:
        return len(self.grid)

    @property
    def dtype(self):
        return self.weights.dtype

    @property
    def nnz(self) -> int:  # dense-equivalent entry count (for Info())
        return int(np.prod(self.grid)) * len(self.offsets)

    def apply(self, x):
        g = x.reshape(self.grid + x.shape[1:])
        y = None
        for w_idx, off in enumerate(self.offsets):
            src = g
            # shift = slice source and destination windows per axis
            src_sl, dst_sl = [], []
            for ax, o in enumerate(off):
                nax = self.grid[ax]
                if o >= 0:
                    src_sl.append(slice(o, nax))
                    dst_sl.append(slice(0, nax - o))
                else:
                    src_sl.append(slice(0, nax + o))
                    dst_sl.append(slice(-o, nax))
            term = jnp.zeros_like(g)
            term = term.at[tuple(dst_sl)].set(g[tuple(src_sl)])
            contrib = self.weights[w_idx] * term
            y = contrib if y is None else y + contrib
        return y.reshape(x.shape)

    def to_csr(self):
        from .csr import CSR

        idx = np.arange(int(np.prod(self.grid))).reshape(self.grid)
        rows, cols, vals = [], [], []
        w = np.asarray(self.weights)
        for k, off in enumerate(self.offsets):
            src_sl, dst_sl = [], []
            for ax, o in enumerate(off):
                nax = self.grid[ax]
                if o >= 0:
                    src_sl.append(slice(o, nax))
                    dst_sl.append(slice(0, nax - o))
                else:
                    src_sl.append(slice(0, nax + o))
                    dst_sl.append(slice(-o, nax))
            r = idx[tuple(dst_sl)].ravel()
            c = idx[tuple(src_sl)].ravel()
            rows.append(r)
            cols.append(c)
            vals.append(np.full(len(r), w[k]))
        return CSR.from_coo(
            np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), self.shape,
        )


def laplace2d_stencil(n: int, dtype=np.float64) -> Stencil:
    """The reference's ndim=2 Laplace stencil (stencil_types.hpp:36-39,
    host_stencil_laplace2d.cpp) on an n×n grid."""
    return Stencil(
        weights=jnp.asarray([4.0, -1.0, -1.0, -1.0, -1.0], dtype=dtype),
        offsets=((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
        grid=(n, n),
    )


def laplace3d_stencil(n: int, dtype=np.float64) -> Stencil:
    return Stencil(
        weights=jnp.asarray([6.0] + [-1.0] * 6, dtype=dtype),
        offsets=((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                 (0, 0, -1), (0, 0, 1)),
        grid=(n, n, n),
    )
