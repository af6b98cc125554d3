"""Approximate-inverse, block/Schwarz, ME, saddle-point preconditioners and
dense direct solvers (reference parity: preconditioner_ai/as/blockprecond/
multielimination/saddlepoint + solvers/direct)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import rocalution_tpu as rt
from rocalution_tpu.precond import (additive_schwarz, aichebyshev,
                                    block_jacobi, block_precond, fsai, ilu,
                                    jacobi, multi_elimination,
                                    restricted_additive_schwarz,
                                    saddle_point_precond, spai, tns,
                                    variable_precond)
from rocalution_tpu.solvers import inversion, lu, lu_factor, qr


@pytest.fixture
def prob(rng):
    A = rt.laplacian_2d(12)
    x_true = rng.standard_normal(A.shape[0])
    b = np.asarray(rt.spmv(A, x_true))
    return A, b, x_true


def _check(solver, A, b, x_true, M, name, tol=1e-5):
    x, info = solver(A, b, M=M, rel_tol=1e-10, max_iter=2000)
    assert bool(info.converged), f"{name}: status={int(info.status)}"
    err = np.linalg.norm(np.asarray(x) - x_true)
    assert err < tol * max(1, np.linalg.norm(x_true)), f"{name}: {err}"
    return int(info.iterations)


AI_PRECONDS = {
    "fsai1": lambda A: fsai(A, 1),
    "fsai2": lambda A: fsai(A, 2),
    "spai": spai,
    "tns": tns,
    "aichebyshev": aichebyshev,
}


@pytest.mark.parametrize("name", sorted(AI_PRECONDS))
def test_approx_inverse_preconds(name, prob):
    A, b, x_true = prob
    solver = rt.cg if name.startswith("fsai") else rt.fgmres
    it = _check(solver, A, b, x_true, AI_PRECONDS[name](A), name)
    _, info0 = solver(A, b, rel_tol=1e-10, max_iter=2000)
    if name in ("fsai2", "spai"):
        assert it < int(info0.iterations), name


def test_fsai_spd_symmetric(prob):
    # FSAI must preserve SPD: CG with it converges and G^T G r is symmetric
    A, b, x_true = prob
    M = fsai(A, 2)
    r = np.random.default_rng(1).standard_normal(A.shape[0])
    s = np.random.default_rng(2).standard_normal(A.shape[0])
    # <M r, s> == <r, M s>
    lhs = float(np.dot(np.asarray(M(jnp.asarray(r))), s))
    rhs = float(np.dot(r, np.asarray(M(jnp.asarray(s)))))
    assert abs(lhs - rhs) < 1e-10 * max(1, abs(lhs))


BLOCK_PRECONDS = {
    "block_jacobi4": lambda A: block_jacobi(A, 4),
    "block_jacobi8": lambda A: block_jacobi(A, 8),
    "as": lambda A: additive_schwarz(A, num_blocks=4, overlap=6),
    "ras": lambda A: restricted_additive_schwarz(A, num_blocks=4, overlap=6),
    "as_ilu": lambda A: additive_schwarz(A, 4, 6, inner=lambda m: ilu(m)),
}


@pytest.mark.parametrize("name", sorted(BLOCK_PRECONDS))
def test_block_preconds(name, prob):
    A, b, x_true = prob
    _check(rt.fgmres, A, b, x_true, BLOCK_PRECONDS[name](A), name)


def test_block_precond_composition(prob):
    A, b, x_true = prob
    from rocalution_tpu.ops.extract import extract_submatrices

    nb = 4
    blocks = extract_submatrices(A, nb)
    solvers = [jacobi(blocks[i][i]) for i in range(nb)]
    M = block_precond(A, nb, solvers)
    _check(rt.fgmres, A, b, x_true, M, "block_diag")
    Ml = block_precond(A, nb, solvers, lower=True)
    _check(rt.fgmres, A, b, x_true, Ml, "block_lower")


def test_multi_elimination(prob):
    A, b, x_true = prob
    M = multi_elimination(A, levels=2)
    it = _check(rt.fgmres, A, b, x_true, M, "me2")
    _, info0 = rt.fgmres(A, b, rel_tol=1e-10, max_iter=2000)
    assert it <= int(info0.iterations)


def test_variable_precond(prob):
    A, b, x_true = prob
    M = variable_precond([jacobi(A), tns(A)])
    _check(rt.fgmres, A, b, x_true, M, "variable")


def test_variable_precond_cycles_per_application():
    """The rotation must advance per *application*, even when the apply is
    traced once inside a lax.while_loop body (reference semantics:
    preconditioner.hpp:431-445 — a new sub-preconditioner every call)."""
    import jax
    import jax.numpy as jnp

    M = variable_precond([lambda r: r * 2.0, lambda r: r * 3.0])

    @jax.jit
    def run(v):
        def body(carry):
            i, x = carry
            return (i + 1, M(x))

        return jax.lax.while_loop(lambda c: c[0] < 4, body, (0, v))[1]

    out = run(jnp.ones(4))
    # alternating 2x, 3x, 2x, 3x => 36 (a per-trace-site cycle would give 16)
    np.testing.assert_allclose(np.asarray(out), 36.0)


def test_saddle_point():
    rng = np.random.default_rng(5)
    m, k = 40, 12
    Ab = rng.standard_normal((m, m))
    Ablk = Ab @ Ab.T + m * np.eye(m)
    B = rng.standard_normal((m, k))
    K = np.block([[Ablk, B], [B.T, np.zeros((k, k))]])
    Kc = rt.CSR.from_dense(K)
    x_true = rng.standard_normal(m + k)
    b = K @ x_true
    M = saddle_point_precond(Kc, m)
    x, info = rt.fgmres(Kc, b, M=M, rel_tol=1e-12, max_iter=500)
    assert bool(info.converged)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-5 * np.linalg.norm(x_true)


def test_direct_solvers(rng):
    n = 30
    Ad = rng.standard_normal((n, n)) + n * np.eye(n)
    A = rt.CSR.from_dense(Ad)
    x_true = rng.standard_normal(n)
    b = jnp.asarray(Ad @ x_true)
    for name, solver in [("inversion", inversion), ("lu", lu), ("qr", qr)]:
        x, info = solver(A, b)
        assert np.linalg.norm(np.asarray(x) - x_true) < 1e-8, name
        assert int(info.status) == 1
    solve = lu_factor(A)
    x = solve(b)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-8


def test_lu_f64_native_accuracy(rng):
    """f64 input is factored natively in f64: one LU solve reaches
    backward error ~1e-12 with no refinement step."""
    n = 60
    Ad = rng.standard_normal((n, n)) + np.sqrt(n) * np.eye(n)
    x_true = rng.standard_normal(n)
    b = Ad @ x_true
    x, info = lu(rt.CSR.from_dense(Ad), jnp.asarray(b))
    x = np.asarray(x)
    assert x.dtype == np.float64
    rel_res = np.linalg.norm(b - Ad @ x) / np.linalg.norm(b)
    assert rel_res < 1e-12, rel_res
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-12


def test_solver_as_preconditioner(prob):
    # "any solver preconditions any solver" (reference README.md:76-80):
    # inner CG (loose) preconditions outer FGMRES
    A, b, x_true = prob

    def inner(r):
        z, _ = rt.cg(A, r, rel_tol=1e-2, max_iter=50)
        return z

    _check(rt.fgmres, A, b, x_true, inner, "cg-in-fgmres")
