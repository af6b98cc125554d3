"""Dense direct solvers: Inversion, LU, QR.

Reference parity: src/solvers/direct/{inversion,lu,qr}.{hpp,cpp} —
dense-only direct solvers (Local only). Here they operate on any format by
densifying (the reference requires ConvertToDENSE the same way).

All three run natively in the operand's dtype (f64 included): QR through
Householder `jnp.linalg.qr`, LU through `jax.scipy.linalg.lu_factor`
(cuSOLVER on a GPU). Dense products ask for `Precision.HIGHEST`, so an f32
solve on a GPU does not drop to TF32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import lu_factor as _lu_factor, lu_solve as _lu_solve
from jax.scipy.linalg import solve_triangular

from ..formats import DENSE
from .iter_ctrl import SolverInfo


def _dense(A) -> jnp.ndarray:
    if isinstance(A, DENSE):
        return A.data
    if hasattr(A, "numpy_triplet") and getattr(A, "_host_cache", None):
        # densify on the host (setup phase: avoid the eager scatter compile)
        import scipy.sparse as sp

        d, i, p = A.numpy_triplet()
        return jnp.asarray(
            sp.csr_matrix((d, i, p), shape=A.shape).toarray()
        )
    if hasattr(A, "to_dense"):
        return jnp.asarray(A.to_dense())
    return jnp.asarray(A)


def _matmul(A, x):
    return jnp.matmul(A, x, precision=jax.lax.Precision.HIGHEST)


def _info(b, r):
    res = jnp.linalg.norm(r)
    return SolverInfo(
        iterations=jnp.asarray(1),
        status=jnp.asarray(1),
        init_res=jnp.linalg.norm(b),
        final_res=res,
        history=jnp.stack([jnp.linalg.norm(b), res]),
    )


def qr_factor(A):
    """Build phase: Householder QR, returns a solve closure (reference
    Build/Solve split)."""
    Ad = _dense(A)
    Q, R = jnp.linalg.qr(Ad)
    return lambda b: solve_triangular(R, _matmul(Q.T.conj(), b), lower=False)


def qr(A, b):
    """Dense QR solve (reference: direct/qr.cpp — Householder QR)."""
    Ad = _dense(A)
    x = qr_factor(A)(b)
    return x, _info(b, b - _matmul(Ad, x))


def inversion(A, b):
    """Solve by explicit inverse (reference: direct/inversion.cpp). The
    inverse is built QR-wise (R^{-1} Q^H)."""
    Ad = _dense(A)
    Q, R = jnp.linalg.qr(Ad)
    inv = solve_triangular(R, Q.T.conj(), lower=False)
    x = _matmul(inv, b)
    return x, _info(b, b - _matmul(Ad, x))


def lu_factor(A):
    """Build phase for `lu`: LU factors in the operand's dtype, returns a
    solve closure."""
    f = _lu_factor(_dense(A))
    return lambda b: _lu_solve(f, b)


def lu(A, b):
    """Dense LU solve with partial pivoting (reference: direct/lu.cpp)."""
    Ad = _dense(A)
    x = lu_factor(A)(b)
    return x, _info(b, b - _matmul(Ad, x))
