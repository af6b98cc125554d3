"""Full Krylov family — manufactured-solution oracle (reference test
strategy, clients/include/testing_*.hpp: b = A @ 1, random x0, final error
below threshold), parameterized over solver × preconditioner like the
reference's INSTANTIATE_TEST_CASE_P matrices (e.g. test_cg.cpp:31-69)."""

import jax
import numpy as np
import pytest

import rocalution_tpu as rt

SPD_SOLVERS = [rt.cg, rt.cr, rt.fcg]
GENERAL_SOLVERS = [
    rt.bicgstab, rt.bicgstabl, rt.gmres, rt.fgmres, rt.idr, rt.qmrcgstab,
]


def _laplacian_problem(n=16, rng=None):
    A = rt.laplacian_2d(n)
    ones = np.ones(A.shape[0])
    b = np.asarray(rt.spmv(A, ones))
    x0 = rng.standard_normal(A.shape[0]) if rng is not None else None
    return A, b, x0, ones


@pytest.mark.parametrize("solver", SPD_SOLVERS + GENERAL_SOLVERS)
def test_solver_laplacian(solver, rng):
    A, b, x0, ones = _laplacian_problem(12, rng)
    x, info = solver(A, b, x0, rel_tol=1e-10, max_iter=2000)
    assert bool(info.converged), f"{solver.__name__}: status={int(info.status)}"
    assert np.linalg.norm(np.asarray(x) - ones) < 1e-6


@pytest.mark.parametrize("solver", SPD_SOLVERS + GENERAL_SOLVERS)
def test_solver_jacobi_preconditioned(solver, rng):
    A, b, x0, ones = _laplacian_problem(12, rng)
    M = rt.jacobi(A)
    x, info = solver(A, b, x0, M, rel_tol=1e-10, max_iter=2000)
    assert bool(info.converged)
    assert np.linalg.norm(np.asarray(x) - ones) < 1e-6


@pytest.mark.parametrize(
    "solver", [rt.cg, rt.bicgstab, rt.gmres, rt.idr, rt.qmrcgstab,
               rt.bicgstabl, rt.cr, rt.fcg, rt.fgmres]
)
def test_solver_under_jit(solver):
    A = rt.laplacian_2d(8)
    b = np.asarray(rt.spmv(A, np.ones(A.shape[0])))
    solve = jax.jit(lambda A, b: solver(A, b, rel_tol=1e-9, max_iter=500))
    x, info = solve(A, b)
    assert bool(info.converged)
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-5


def test_nonsymmetric_convection_diffusion(rng):
    # upwind convection makes A nonsymmetric — CG is not expected to work,
    # the nonsymmetric family is
    n = 12
    A = rt.laplacian_2d(n)
    d, i, p = A.numpy_triplet()
    rows = A.numpy_rows()
    d = d + 0.3 * (np.asarray(i) > rows)  # skew upper entries
    A = rt.CSR.from_arrays(d, i, p, A.shape)
    ones = np.ones(A.shape[0])
    b = np.asarray(rt.spmv(A, ones))
    for solver in GENERAL_SOLVERS:
        x, info = solver(A, b, rel_tol=1e-10, max_iter=3000)
        assert bool(info.converged), solver.__name__
        err = np.linalg.norm(np.asarray(x) - ones)
        assert err < 1e-5, f"{solver.__name__}: err={err}"


def test_gmres_basis_size():
    A, b, _, ones = _laplacian_problem(10)
    x, info = rt.gmres(A, b, basis_size=10, rel_tol=1e-10, max_iter=2000)
    assert bool(info.converged)
    assert np.linalg.norm(np.asarray(x) - ones) < 1e-6


def test_bicgstabl_orders(rng):
    A, b, x0, ones = _laplacian_problem(10, rng)
    for l in (1, 2, 4):
        x, info = rt.bicgstabl(A, b, x0, order=l, rel_tol=1e-10, max_iter=2000)
        assert bool(info.converged), f"l={l}"
        assert np.linalg.norm(np.asarray(x) - ones) < 1e-6


def test_idr_shadow_spaces(rng):
    A, b, x0, ones = _laplacian_problem(10, rng)
    for s in (1, 2, 4, 8):
        x, info = rt.idr(A, b, x0, shadow_space=s, rel_tol=1e-10,
                         max_iter=2000, seed=7)
        assert bool(info.converged), f"s={s}"
        assert np.linalg.norm(np.asarray(x) - ones) < 1e-6


def test_chebyshev_with_gershgorin():
    A, b, _, ones = _laplacian_problem(10)
    lmin, lmax = rt.gershgorin(A)
    lmin = max(float(lmin), 1e-3)  # Laplacian Gershgorin lower bound is 0
    x, info = rt.chebyshev(A, b, lambda_min=lmin, lambda_max=float(lmax),
                           rel_tol=1e-8, max_iter=5000)
    assert bool(info.converged)
    assert np.linalg.norm(np.asarray(x) - ones) < 1e-4


def test_fixed_point_jacobi():
    A, b, _, ones = _laplacian_problem(8)
    M = rt.jacobi(A)
    x, info = rt.fixed_point(A, b, M=M, omega=0.9, rel_tol=1e-6,
                             max_iter=20000)
    assert bool(info.converged)
    assert np.linalg.norm(np.asarray(x) - ones) < 1e-3


def test_mixed_precision_dc():
    A, b, _, ones = _laplacian_problem(12)
    x, info = rt.mixed_precision_dc(A, b, rel_tol=1e-10, max_iter=30)
    assert int(info.status) == 2
    assert np.linalg.norm(np.asarray(x) - ones) < 1e-6
    assert np.asarray(x).dtype == np.float64


def test_mixed_precision_inner_keeps_fast_path():
    """The low-precision inner operator keeps its host cache through
    `_cast_format` (a bare tree.map rebuild would drop `_host_cache`, and
    host-side setup on the cast operator would read the device back)."""
    from rocalution_tpu.solvers.mixed_precision import _cast_format

    A, _, _, _ = _laplacian_problem(12)
    A_low = _cast_format(A, np.float32)
    cache = getattr(A_low, "_host_cache", None)
    assert cache and "data" in cache
    assert cache["data"].dtype == np.float32


def test_power_method():
    A = rt.laplacian_2d(10)
    lam, _ = rt.power_method(A, iters=300)
    dense = np.asarray(A.to_dense())
    lam_true = np.max(np.linalg.eigvalsh(dense))
    assert abs(float(lam) - lam_true) / lam_true < 1e-3


@pytest.mark.parametrize("res_norm", [1, 2, 3])
@pytest.mark.parametrize("solver", [rt.cg, rt.bicgstab, rt.fixed_point])
def test_residual_norm_selection(solver, res_norm, rng):
    """SetResidualNorm analog (reference solver.hpp:386, solver.cpp:433):
    convergence checks run under the selected L1/L2/Linf norm; all three
    must converge to the manufactured solution, and the recorded residual
    history must actually BE that norm of the true residual."""
    A, b, x0, ones = _laplacian_problem(12, rng)
    kw = dict(rel_tol=1e-10, max_iter=3000, res_norm=res_norm,
              record_history=True)
    if solver is rt.fixed_point:
        d = np.asarray(rt.precond.jacobi(A)(np.ones(A.shape[0])))
        x, info = solver(A, b, M=lambda r: d * r, omega=0.8, **kw)
    else:
        x, info = solver(A, b, x0, **kw)
    assert bool(info.converged), (solver.__name__, int(info.status))
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-6
    # init_res entry of the history = chosen norm of b - A x0
    r0 = b - np.asarray(rt.spmv(A, np.asarray(x0)
                                if solver is not rt.fixed_point
                                else np.zeros_like(b)))
    want = {1: np.sum(np.abs(r0)), 2: np.linalg.norm(r0),
            3: np.max(np.abs(r0))}[res_norm]
    got = float(np.asarray(info.history)[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_residual_norm_invalid():
    A, b, x0, _ = _laplacian_problem(8)
    with pytest.raises(ValueError):
        rt.cg(A, b, res_norm=7)
