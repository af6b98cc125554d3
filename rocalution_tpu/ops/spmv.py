"""Sparse matrix–vector (and multi-vector) products for every format.

Reference parity: per-format Apply/ApplyAdd (HostMatrix*::Apply,
HIPAcceleratorMatrix*::Apply via rocSPARSE csrmv/coomv/ellmv/...,
e.g. hip_matrix_csr.cpp:1215-1276). Formulation in plain JAX, left to XLA:

* CSR/COO  → vectorized multiply + `segment_sum` (no per-row loops),
* ELL      → one gather + dense (nrow, width) multiply + row-reduce,
* DIA      → gather-free static shifted multiplies (fastest for stencils),
* BCSR     → one batched `dot_general` over dense blocks,
* MCSR     → diagonal multiply + CSR off-diagonal,
* DENSE    → plain matmul.

`x` may be (n,) or (n, k) — every path supports blocked right-hand sides
(SpMM) for free, which is how multiple-RHS solves and AMG interpolation
batch their products.

Dense products ask for `Precision.HIGHEST`: a float32 product on a GPU may
otherwise run in TF32, which keeps about three decimal digits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..formats import BCSR, COO, CSR, DENSE, DIA, ELL, HYB, MCSR
from ..formats.stencil import Stencil


@functools.singledispatch
def spmv(A, x):
    """y = A @ x (reference: Operator::Apply, src/base/operator.hpp)."""
    if callable(A):  # matrix-free operator
        return A(x)
    raise TypeError(f"spmv: unsupported operator type {type(A).__name__}")


def spmv_add(A, x, y, alpha=1.0):
    """y + alpha * A @ x (reference: Operator::ApplyAdd)."""
    return y + alpha * spmv(A, x)


def _expand(vals, x_gathered):
    """Broadcast 1-D nonzero values over trailing RHS dims."""
    if x_gathered.ndim == vals.ndim:
        return vals * x_gathered
    return vals[(...,) + (None,) * (x_gathered.ndim - vals.ndim)] * x_gathered


@spmv.register(CSR)
def _spmv_csr(A: CSR, x):
    prod = _expand(A.data, x[A.indices])
    return jax.ops.segment_sum(
        prod, A.row_ids, num_segments=A.shape[0], indices_are_sorted=True
    )


@spmv.register(COO)
def _spmv_coo(A: COO, x):
    prod = _expand(A.data, x[A.col])
    return jax.ops.segment_sum(prod, A.row, num_segments=A.shape[0])


@spmv.register(ELL)
def _spmv_ell(A: ELL, x):
    safe_ind = jnp.maximum(A.indices, 0)
    xs = x[safe_ind]                     # (nrow, width[, k])
    prod = _expand(A.data, xs)
    # padded entries have data == 0, so no masking needed in the product
    return jnp.sum(prod, axis=1)


@spmv.register(DIA)
def _spmv_dia(A: DIA, x):
    # One fused elementwise pass: pad x once, then every diagonal is a
    # static slice of the pad — XLA fuses the whole sum into a single
    # elementwise loop (the scatter-style `.at[lo:hi].add` formulation breaks
    # fusion and costs one memory pass per diagonal).
    n, m = A.shape
    if not A.offsets:
        return jnp.zeros((n,) + x.shape[1:], dtype=jnp.result_type(A.data, x))
    lo_pad = max(0, -min(A.offsets))
    hi_pad = max(0, max(A.offsets) + n - m)
    pad_widths = ((lo_pad, hi_pad),) + ((0, 0),) * (x.ndim - 1)
    xpad = jnp.pad(x, pad_widths)
    y = None
    for d, off in enumerate(A.offsets):
        # rows outside [max(0,-off), min(n, m-off)) must see zero: padded
        # x slots are zero, and A.data is zero-padded there by convert
        seg = _expand(A.data[d, :n], xpad[lo_pad + off: lo_pad + off + n])
        y = seg if y is None else y + seg
    return y


@spmv.register(HYB)
def _spmv_hyb(A: HYB, x):
    return _spmv_ell(A.ell, x) + _spmv_coo(A.coo, x)


@spmv.register(BCSR)
def _spmv_bcsr(A: BCSR, x):
    bd = A.block_dim
    nrowb = A.nrowb
    ncolb = -(-A.shape[1] // bd)
    vec = x.ndim == 1
    xk = x[:, None] if vec else x
    k = xk.shape[1]
    pad = ncolb * bd - xk.shape[0]
    if pad:
        xk = jnp.concatenate([xk, jnp.zeros((pad, k), xk.dtype)], axis=0)
    xb = xk.reshape(ncolb, bd, k)[A.indices]          # (nnzb, bd, k)
    prod = jnp.einsum(
        "nij,njk->nik", A.data, xb,
        preferred_element_type=jnp.result_type(A.data, x),
        precision=jax.lax.Precision.HIGHEST,
    )
    yb = jax.ops.segment_sum(
        prod, A.row_ids, num_segments=nrowb, indices_are_sorted=True
    )
    y = yb.reshape(nrowb * bd, k)[: A.shape[0]]
    return y[:, 0] if vec else y


@spmv.register(MCSR)
def _spmv_mcsr(A: MCSR, x):
    n = min(A.shape)
    diag_part = _expand(A.diag[:n], x[:n])
    y = _spmv_csr(A.offd, x)
    return y.at[:n].add(diag_part)


@spmv.register(Stencil)
def _spmv_stencil(A: Stencil, x):
    return A.apply(x)


@spmv.register(DENSE)
def _spmv_dense(A: DENSE, x):
    return jnp.matmul(
        A.data, x, preferred_element_type=jnp.result_type(A.data, x),
        precision=jax.lax.Precision.HIGHEST,
    )


def as_operator(A):
    """Normalize a matrix pytree / callable into a closure x -> A @ x."""
    if callable(A) and not isinstance(
        A, (CSR, COO, ELL, DIA, HYB, BCSR, MCSR, DENSE)
    ):
        return A
    return lambda x: spmv(A, x)
