"""Every dense product on a device path asks for `Precision.HIGHEST`.

A float32 matrix product on a GPU may run in TF32 (about three decimal
digits) unless a precision is given, so each site passes it per call. The
check walks the traced program: every `dot_general` with a matrix (rank >= 2)
operand must carry HIGHEST. Rank-1 dots (inner products) are not products a
GPU runs on its tensor cores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rocalution_tpu as rt
from rocalution_tpu.precond.block import block_jacobi
from rocalution_tpu.precond.ilu import bsr_ilu0
from rocalution_tpu.precond.me import _dense_inverse_solver
from rocalution_tpu.solvers import inversion, lu, qr


def _dots(jaxpr):
    """All dot_general equations of a jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dots(sub)


def _is_highest(precision):
    if isinstance(precision, tuple):
        return all(p == jax.lax.Precision.HIGHEST for p in precision)
    return precision == jax.lax.Precision.HIGHEST


def _problem():
    A = rt.laplacian_2d(6, dtype=np.float32)
    b = jnp.ones(A.shape[0], jnp.float32)
    return A, b


def _site(name):
    A, b = _problem()
    if name == "gmres":
        return lambda b: rt.gmres(A, b, rel_tol=1e-6, max_iter=40)[0], b
    if name == "idr":
        return lambda b: rt.idr(A, b, rel_tol=1e-6, max_iter=40)[0], b
    if name == "bcsr":
        B = rt.convert(A, "BCSR")
        return lambda b: rt.spmv(B, b), b
    if name == "dense":
        D = rt.convert(A, "DENSE")
        return lambda b: rt.spmv(D, b), b
    if name == "ilu":
        M = bsr_ilu0(rt.convert(A, "BCSR"), method="jacobi", sweeps=2)
        return M, b
    if name == "block":
        return block_jacobi(A, num_blocks=4), b
    if name == "me":
        return _dense_inverse_solver(A), b
    if name == "direct":
        return lambda b: (qr(A, b)[0], lu(A, b)[0], inversion(A, b)[0]), b
    raise ValueError(name)


@pytest.mark.parametrize("name", ["gmres", "idr", "bcsr", "dense", "ilu",
                                  "block", "me", "direct"])
def test_dense_products_ask_for_highest(name):
    fn, b = _site(name)
    dots = list(_dots(jax.make_jaxpr(fn)(b).jaxpr))
    matrix_dots = [e for e in dots
                   if max(v.aval.ndim for v in e.invars) >= 2]
    assert matrix_dots, f"{name}: no matrix product traced"
    for e in matrix_dots:
        assert _is_highest(e.params["precision"]), (
            f"{name}: dot_general at precision {e.params['precision']}")


@pytest.mark.gpu
def test_dense_f32_spmv_is_not_tf32_on_gpu(rng):
    """On the card, a 1024² f32 DENSE apply agrees with the f64 product to
    f32 accuracy; TF32 would err by ~1e-3."""
    n = 1024
    Ad = rng.standard_normal((n, n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(rt.spmv(rt.DENSE.from_array(Ad), jnp.asarray(x)),
                   np.float64)
    ref = Ad.astype(np.float64) @ x.astype(np.float64)
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-5
