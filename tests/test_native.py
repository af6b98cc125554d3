"""Native C++ kernel parity tests — the native sweeps must produce exactly
the factors of the numpy reference implementations (the same dual-path
equivalence the reference enforces between host and HIP backends)."""

import numpy as np
import pytest

import rocalution_tpu as rt
import rocalution_tpu.ops.factorize as fz
from rocalution_tpu import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


@pytest.fixture
def A():
    return rt.laplacian_2d(16)


def _numpy_path(fn, *args):
    orig = fz._use_native
    fz._use_native = lambda d: False
    try:
        return fn(*args)
    finally:
        fz._use_native = orig


def test_ilu0_parity(A):
    L1, U1 = fz.ilu0(A)
    L2, U2 = _numpy_path(fz.ilu0, A)
    np.testing.assert_allclose(
        np.asarray(L1.to_dense()), np.asarray(L2.to_dense()), atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(U1.to_dense()), np.asarray(U2.to_dense()), atol=1e-14)


def test_ic0_parity(A):
    L1 = fz.ic0(A)
    L2 = _numpy_path(fz.ic0, A)
    np.testing.assert_allclose(
        np.asarray(L1.to_dense()), np.asarray(L2.to_dense()), atol=1e-14)


def test_ilut_parity(A):
    L1, U1 = fz.ilut(A, 1e-4, 10)
    L2, U2 = _numpy_path(fz.ilut, A, 1e-4, 10)
    S = np.asarray(A.to_dense())
    r1 = np.linalg.norm(np.asarray(L1.to_dense()) @ np.asarray(U1.to_dense()) - S)
    r2 = np.linalg.norm(np.asarray(L2.to_dense()) @ np.asarray(U2.to_dense()) - S)
    np.testing.assert_allclose(r1, r2, rtol=1e-10)


def test_ilup_parity(A):
    L1, U1 = fz.ilup(A, 1)
    L2, U2 = _numpy_path(fz.ilup, A, 1)
    np.testing.assert_allclose(
        np.asarray(L1.to_dense()), np.asarray(L2.to_dense()), atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(U1.to_dense()), np.asarray(U2.to_dense()), atol=1e-14)


def test_mtx_native_parse(tmp_path):
    from rocalution_tpu.io import read_mtx, write_mtx

    A = rt.utils.generators.random_spd(50, density=0.08, seed=9)
    p = str(tmp_path / "a.mtx")
    write_mtx(p, A)
    B = read_mtx(p)
    np.testing.assert_allclose(
        np.asarray(B.to_dense()), np.asarray(A.to_dense()), rtol=1e-12)


def _no_native(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


def test_greedy_aggregate_parity(monkeypatch, rng):
    from rocalution_tpu.solvers.multigrid import aggregation as ag

    A = rt.laplacian_2d(20, dtype=np.float64)
    C = ag.strength_connect(ag._scipy(A))
    a_native = ag.greedy_aggregate(C)
    _no_native(monkeypatch)
    a_numpy = ag.greedy_aggregate(C)
    np.testing.assert_array_equal(a_native, a_numpy)


def test_pairwise_parity(monkeypatch, rng):
    from rocalution_tpu.solvers.multigrid import aggregation as ag

    A = rt.laplacian_2d(20, dtype=np.float64)
    P1, R1, Ac1 = ag.pairwise_level(A, npass=2)
    _no_native(monkeypatch)
    P2, R2, Ac2 = ag.pairwise_level(A, npass=2)
    np.testing.assert_allclose(
        np.asarray(P1.to_dense()), np.asarray(P2.to_dense()), atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(Ac1.to_dense()), np.asarray(Ac2.to_dense()), atol=1e-14)


def test_native_breakdown_rcs():
    """Error paths through ctypes: missing diagonal and zero pivots
    surface as exceptions naming the breaking row."""
    from rocalution_tpu import native

    if not native.available():
        pytest.skip("native library not built")

    # ILU(0): row 1 has no diagonal entry
    indptr = np.array([0, 1, 2], np.int64)
    cols = np.array([0, 0], np.int32)
    data = np.array([2.0, 1.0])
    with pytest.raises(ZeroDivisionError, match="row 1"):
        native.ilu0_inplace(indptr, cols, data.copy())

    # ILU(0): zero pivot propagates (diag of row 0 is 0, used by row 1)
    indptr = np.array([0, 2, 4], np.int64)
    cols = np.array([0, 1, 0, 1], np.int32)
    data = np.array([0.0, 1.0, 1.0, 1.0])
    with pytest.raises(ZeroDivisionError, match="row 0"):
        native.ilu0_inplace(indptr, cols, data.copy())

    # IC(0): non-SPD lower triangle -> nonpositive pivot
    indptr = np.array([0, 1, 3], np.int64)
    cols = np.array([0, 0, 1], np.int32)
    data = np.array([1.0, 5.0, 1.0])   # 1 - 25 < 0 at row 1
    with pytest.raises(ValueError, match="row 1"):
        native.ic0_inplace(indptr, cols, data.copy())

    # ILUT: zero pivot
    indptr = np.array([0, 2, 4], np.int64)
    cols = np.array([0, 1, 0, 1], np.int32)
    data = np.array([0.0, 1.0, 1.0, 1.0])
    with pytest.raises(ZeroDivisionError):
        native.ilut(indptr, cols, data.copy(), 1e-3, 4)
