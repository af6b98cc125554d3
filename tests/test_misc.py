"""Complex dtype support, validators, and misc object semantics."""

import jax.numpy as jnp
import numpy as np
import pytest

import rocalution_tpu as rt
from rocalution_tpu.utils.validate import (ValidationError, check_matrix,
                                           check_vector)


def _hermitian_problem(n=60, seed=0):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = B @ B.conj().T + n * np.eye(n)      # HPD
    A = rt.CSR.from_dense(H)
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = H @ x_true
    return A, jnp.asarray(b), x_true


def test_cg_complex_symmetric():
    # the reference's CG uses DotNonConj (cg.cpp) — the complex-SYMMETRIC
    # variant; oracle: A = S + i*T with S SPD, T symmetric small
    rng = np.random.default_rng(1)
    n = 60
    B = rng.standard_normal((n, n))
    S = B @ B.T + n * np.eye(n)
    C = rng.standard_normal((n, n))
    T = 0.05 * (C + C.T)
    H = S + 1j * T
    A = rt.CSR.from_dense(H)
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = jnp.asarray(H @ x_true)
    x, info = rt.cg(A, b, rel_tol=1e-12, max_iter=500)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-8 * np.linalg.norm(x_true)


def test_gmres_complex():
    A, b, x_true = _hermitian_problem(40, seed=3)
    x, info = rt.gmres(A, b, rel_tol=1e-10, max_iter=500)
    assert int(info.status) in (2, 1)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-6 * np.linalg.norm(x_true)


def test_bicgstab_complex_nonhermitian():
    rng = np.random.default_rng(7)
    n = 50
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = M * 0.1 + n * np.eye(n)            # diagonally dominant
    A = rt.CSR.from_dense(H)
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = jnp.asarray(H @ x_true)
    x, info = rt.bicgstab(A, b, rel_tol=1e-12, max_iter=500)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-7 * np.linalg.norm(x_true)


def test_validators():
    A = rt.laplacian_2d(6)
    check_matrix(A)
    check_vector(np.ones(5))
    with pytest.raises(ValidationError):
        check_vector(np.array([1.0, np.nan]))
    bad = rt.CSR.from_arrays(
        np.array([np.inf]), np.array([0]), np.array([0, 1]), (1, 1)
    )
    with pytest.raises(ValidationError):
        check_matrix(bad)


def test_blas1_surface(rng):
    # the LocalVector op surface (reference local_vector.hpp:68-670)
    from rocalution_tpu.ops import blas1

    x = jnp.asarray(rng.standard_normal(32))
    y = jnp.asarray(rng.standard_normal(32))
    assert abs(float(blas1.dot(x, y)) - float(np.dot(np.asarray(x), np.asarray(y)))) < 1e-12
    i, v = blas1.amax(x)
    assert abs(float(v)) == pytest.approx(float(np.max(np.abs(np.asarray(x)))))
    np.testing.assert_allclose(np.asarray(blas1.inclusive_sum(x)),
                               np.cumsum(np.asarray(x)), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(blas1.exclusive_sum(x)),
                               np.cumsum(np.asarray(x)) - np.asarray(x),
                               rtol=1e-10, atol=1e-12)
    perm = rng.permutation(32)
    np.testing.assert_allclose(
        np.asarray(blas1.permute_backward(blas1.permute(x, perm), perm)),
        np.asarray(x), atol=0)


def test_profile_context_manager(tmp_path, rng):
    """jax.profiler hook (SURVEY §5): a trace of a solve is captured."""
    import rocalution_tpu as rt
    from rocalution_tpu.utils.profile import (annotate, latest_trace_file,
                                              profile)

    A = rt.laplacian_2d(8)
    b = np.asarray(rt.spmv(A, np.ones(A.shape[0])))
    logdir = str(tmp_path / "trace")
    with profile(logdir):
        with annotate("cg-smoke"):
            x, info = rt.cg(A, b, rel_tol=1e-8, max_iter=100)
            np.asarray(x)
    assert latest_trace_file(logdir) is not None
    with profile("unused", enabled=False) as d:
        assert d is None


def test_hoisted_jit_no_closure_constants():
    """hoisted_jit lifts closure-captured operator arrays into arguments:
    the compiled HLO must contain no large constants (they would be
    serialized into every compiled program; utils/hoist.py)."""
    import jax

    from rocalution_tpu.utils import hoisted_jit

    A = rt.laplacian_2d(48)
    b = np.asarray(rt.spmv(A, np.ones(A.shape[0])))
    M = rt.jacobi(A)

    def raw(b):
        x, info = rt.cg(A, b, M=M, rel_tol=1e-10, max_iter=400)
        return x, info.iterations

    solve = hoisted_jit(raw, b)
    x, iters = solve(b)
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-6
    x2, _ = solve(b)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x2))
    # the raw closure embeds the operator as jaxpr consts...
    raw_consts = sum(int(np.size(c)) for c in jax.make_jaxpr(raw)(b).consts)
    assert raw_consts >= A.nnz, raw_consts
    # ...the hoisted program carries them as ARGUMENTS instead
    from jax import tree_util

    consts = jax.device_put(list(jax.make_jaxpr(raw)(b).consts))

    def hoisted(consts, b):
        jx = jax.make_jaxpr(raw)(b)
        return jax.core.eval_jaxpr(jx.jaxpr, consts, b)

    embedded = sum(
        int(np.size(c)) for c in jax.make_jaxpr(hoisted)(consts, b).consts)
    assert embedded < 10_000, f"large constants still embedded: {embedded}"


def test_fem_2d_unstructured_generator():
    """P1 FEM stiffness on a random Delaunay mesh (the zero-egress
    SuiteSparse stand-in): SPD, symmetric, variable row degree, RCM
    bounds the bandwidth, and CG+IC0 converges."""
    import numpy as np
    import scipy.sparse as sp

    import rocalution_tpu as rt

    A = rt.fem_2d_unstructured(3000, dtype=np.float64)
    d, i, p = A.numpy_triplet()
    S = sp.csr_matrix((d, i, p), shape=A.shape)
    # symmetric
    asym = abs(S - S.T)
    assert (asym.data.max() if asym.nnz else 0.0) < 1e-12
    # variable degree (genuinely unstructured)
    deg = np.diff(p)
    assert deg.min() >= 3 and deg.max() >= deg.min() + 3
    # RCM keeps the bandwidth well below n
    rows = A.numpy_rows()
    assert np.abs(i - rows).max() < A.shape[0] // 4
    # SPD: CG with ILU(0) converges to the manufactured solution
    # (IC(0) legitimately breaks down here: FEM stiffness on obtuse
    # triangles is SPD but not an M-matrix)
    b = np.asarray(rt.spmv(A, np.ones(A.shape[0])))
    x, info = rt.cg(A, b, M=rt.precond.ilu(A, 0, method="jacobi",
                                           sweeps=8),
                    rel_tol=1e-10, max_iter=3000)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-5
    # the bench configuration (parabolic operator) converges briskly
    Ap = rt.fem_2d_unstructured(3000, dtype=np.float64, parabolic=True)
    bp = np.asarray(rt.spmv(Ap, np.ones(Ap.shape[0])))
    x, info = rt.cg(Ap, bp, M=rt.precond.ilu(Ap, 0, method="jacobi",
                                             sweeps=8),
                    rel_tol=1e-8, max_iter=400)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-5


_COMPILE_ONE = (
    "import jax, rocalution_tpu as rt\n"
    "print(rt.backend.use_compile_cache())\n"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
    "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)\n"
    "jax.jit(lambda x: x * 2 + 1)(1.0).block_until_ready()\n")


def test_compile_cache_follows_env_var(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the compiled program lands
    there and the helper sets nothing of its own."""
    import os
    import subprocess
    import sys

    cache = tmp_path / "jax_cache"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _COMPILE_ONE], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(cache)
    assert any(cache.iterdir()), "nothing was cached"


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    """Unset, the cache goes to <repo>/.jax_cache (a fixed path)."""
    import os

    import jax

    from rocalution_tpu import backend

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    try:
        got = backend.use_compile_cache()
        assert got == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
