"""Format conversions (reference: src/base/host/host_conversion.cpp — any↔CSR↔any).

Conversions are setup-phase operations (like the reference's `ConvertTo`,
local_matrix.cpp) and run host-side with numpy; the resulting format pytree
lives on device. CSR is the hub format.
"""

from __future__ import annotations

import numpy as np

from .base import get_host
from .bcsr import BCSR
from .coo import COO
from .csr import CSR
from .dense import DENSE
from .dia import DIA
from .ell import ELL
from .hyb import HYB
from .mcsr import MCSR

FORMATS = {
    "CSR": CSR,
    "COO": COO,
    "ELL": ELL,
    "DIA": DIA,
    "HYB": HYB,
    "BCSR": BCSR,
    "MCSR": MCSR,
    "DENSE": DENSE,
}


def to_csr(mat) -> CSR:
    """Convert any format to CSR (host-side)."""
    if isinstance(mat, CSR):
        return mat
    if isinstance(mat, COO):
        return CSR.from_coo(
            get_host(mat, "row"), get_host(mat, "col"), get_host(mat, "data"),
            mat.shape,
        )
    if isinstance(mat, ELL):
        ind = get_host(mat, "indices")
        dat = get_host(mat, "data")
        rows = np.broadcast_to(
            np.arange(mat.shape[0])[:, None], ind.shape
        )
        mask = ind >= 0
        return CSR.from_coo(rows[mask], ind[mask], dat[mask], mat.shape)
    if isinstance(mat, DIA):
        dat = get_host(mat, "data")
        n, m = mat.shape
        rows_all, cols_all, vals_all = [], [], []
        for d, off in enumerate(mat.offsets):
            rows = np.arange(max(0, -off), min(n, m - off))
            cols = rows + off
            vals = dat[d, rows]
            keep = vals != 0
            rows_all.append(rows[keep])
            cols_all.append(cols[keep])
            vals_all.append(vals[keep])
        if rows_all:
            return CSR.from_coo(
                np.concatenate(rows_all),
                np.concatenate(cols_all),
                np.concatenate(vals_all),
                mat.shape,
            )
        return CSR.from_coo([], [], [], mat.shape)
    if isinstance(mat, HYB):
        a = to_csr(mat.ell)
        b = to_csr(mat.coo)
        ra = a.numpy_rows(); ca = get_host(a, "indices"); va = get_host(a, "data")
        rb = b.numpy_rows(); cb = get_host(b, "indices"); vb = get_host(b, "data")
        return CSR.from_coo(
            np.concatenate([ra, rb]),
            np.concatenate([ca, cb]),
            np.concatenate([va, vb]),
            mat.shape,
        )
    if isinstance(mat, BCSR):
        blocks = get_host(mat, "data")       # (nnzb, bd, bd)
        brow = get_host(mat, "row_ids")
        bcol = get_host(mat, "indices")
        bd = mat.block_dim
        nb, _, _ = blocks.shape
        br, bc = np.nonzero(np.ones((bd, bd), dtype=bool))
        rows = (brow[:, None] * bd + br[None, :]).reshape(-1)
        cols = (bcol[:, None] * bd + bc[None, :]).reshape(-1)
        vals = blocks.reshape(nb, -1).reshape(-1)
        keep = (vals != 0) & (rows < mat.shape[0]) & (cols < mat.shape[1])
        return CSR.from_coo(rows[keep], cols[keep], vals[keep], mat.shape)
    if isinstance(mat, MCSR):
        o = mat.offd
        rows = o.numpy_rows(); cols = get_host(o, "indices")
        vals = get_host(o, "data")
        n = min(mat.shape)
        drows = np.arange(n)
        diag = get_host(mat, "diag")[:n]
        keep = diag != 0
        return CSR.from_coo(
            np.concatenate([rows, drows[keep]]),
            np.concatenate([cols, drows[keep]]),
            np.concatenate([vals, diag[keep]]),
            mat.shape,
        )
    if isinstance(mat, DENSE):
        return CSR.from_dense(get_host(mat, "data"))
    raise TypeError(f"cannot convert {type(mat).__name__} to CSR")


def cast_values(mat, dtype):
    """Cast a format's value arrays to `dtype`, host-side when caches exist
    (setup-phase: the host caches stay in step with the device arrays)."""
    import jax
    import jax.numpy as jnp

    if isinstance(mat, CSR) and getattr(mat, "_host_cache", None):
        d, i, p = mat.numpy_triplet()
        return CSR.from_arrays(d.astype(dtype), i, p, mat.shape)
    if isinstance(mat, DIA):
        from .base import set_host_cache

        dat = get_host(mat, "data").astype(dtype)
        out = DIA(data=jnp.asarray(dat), offsets=mat.offsets, shape=mat.shape)
        set_host_cache(out, data=dat)
        return out
    return jax.tree.map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.inexact)
        else x,
        mat,
    )


def convert(mat, fmt: str, **kwargs):
    """Convert a matrix to the named format (analog LocalMatrix::ConvertTo)."""
    fmt = fmt.upper()
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; options: {sorted(FORMATS)}")
    if type(mat).__name__ == fmt:
        return mat
    csr = to_csr(mat)
    if fmt == "CSR":
        return csr
    if fmt == "COO":
        return COO.from_arrays(csr.row_ids, csr.indices, csr.data, csr.shape)
    if fmt == "ELL":
        return ELL.from_csr_host(csr, **kwargs)
    if fmt == "DIA":
        return DIA.from_csr_host(csr)
    if fmt == "HYB":
        return HYB.from_csr_host(csr, **kwargs)
    if fmt == "BCSR":
        return BCSR.from_csr_host(csr, kwargs.get("block_dim", 4))
    if fmt == "MCSR":
        return MCSR.from_csr_host(csr)
    if fmt == "DENSE":
        return DENSE.from_csr_host(csr)
    raise AssertionError
