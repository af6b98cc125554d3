"""Format storage + conversion tests (reference analog: test_local_matrix.cpp
conversion coverage)."""

import numpy as np
import pytest

import rocalution_tpu as rt
from rocalution_tpu.formats import convert, to_csr

FORMATS = ["CSR", "COO", "ELL", "DIA", "HYB", "BCSR", "MCSR", "DENSE"]


def dense_of(mat):
    return np.asarray(mat.to_dense())


@pytest.fixture(scope="module")
def A():
    return rt.laplacian_2d(7)


@pytest.mark.parametrize("fmt", FORMATS)
def test_convert_roundtrip(A, fmt):
    ref = dense_of(A)
    B = convert(A, fmt)
    np.testing.assert_allclose(dense_of(B), ref, atol=1e-14)
    # round-trip back to CSR
    C = to_csr(B)
    np.testing.assert_allclose(dense_of(C), ref, atol=1e-14)


def typed(A, dtype):
    """A with its values in `dtype` (complex: a (1+0.5i) phase on each)."""
    d, i, p = A.numpy_triplet()
    if np.issubdtype(dtype, np.complexfloating):
        d = d * (1.0 + 0.5j)
    return rt.CSR.from_arrays(d.astype(dtype), i, p, A.shape)


# f32 sums run in another order than the f64/numpy reference
TOL = {np.float64: 1e-12, np.float32: 1e-5, np.complex128: 1e-12}


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
@pytest.mark.parametrize("fmt", FORMATS)
def test_spmv_matches_dense(A, fmt, dtype, rng):
    At = typed(A, dtype)
    ref = dense_of(At).astype(np.complex128)
    x = rng.standard_normal(A.shape[1]).astype(dtype)
    B = convert(At, fmt)
    y = np.asarray(rt.spmv(B, x))
    assert y.dtype == np.dtype(dtype)
    np.testing.assert_allclose(y, ref @ x, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fmt", FORMATS)
def test_spmm_multiple_rhs(A, fmt, dtype, rng):
    At = typed(A, dtype)
    ref = dense_of(At).astype(np.float64)
    X = rng.standard_normal((A.shape[1], 3)).astype(dtype)
    B = convert(At, fmt)
    Y = np.asarray(rt.spmv(B, X))
    assert Y.shape == (A.shape[0], 3) and Y.dtype == np.dtype(dtype)
    np.testing.assert_allclose(Y, ref @ X, rtol=TOL[dtype], atol=TOL[dtype])


def test_nnz_counts(A):
    n = 7
    expected = 5 * n * n - 4 * n  # 5-point stencil minus boundary
    assert A.nnz == expected
    assert convert(A, "ELL").nnz == expected
    assert convert(A, "DIA").nnz == expected
    assert convert(A, "HYB").nnz == expected


def test_rectangular_csr(rng):
    d = rng.standard_normal((5, 9))
    d[np.abs(d) < 0.7] = 0
    A = rt.CSR.from_dense(d)
    x = rng.standard_normal(9)
    np.testing.assert_allclose(np.asarray(rt.spmv(A, x)), d @ x, rtol=1e-12)


def test_transpose_host(A, rng):
    At = A.transpose_host()
    np.testing.assert_allclose(dense_of(At), dense_of(A).T, atol=0)


def test_localmatrix_scale_addscalar_family(rng):
    """LocalMatrix Scale/AddScalar family + Compress + row/column
    extraction (local_matrix.hpp:128-1327 op tail)."""
    import scipy.sparse as sp
    from rocalution_tpu.ops.extract import (add_scalar, add_scalar_diagonal,
                                            add_scalar_off_diagonal,
                                            compress, extract_column_vector,
                                            extract_row_vector, scale,
                                            scale_diagonal,
                                            scale_off_diagonal)

    A = rt.laplacian_2d(6)
    d, i, p = A.numpy_triplet()
    S = sp.csr_matrix((d, i, p), shape=A.shape)

    def dense(M):
        dd, ii, pp = M.numpy_triplet()
        return sp.csr_matrix((dd, ii, pp), shape=M.shape).toarray()

    D = S.toarray()
    offd = D - np.diag(np.diag(D))
    np.testing.assert_allclose(dense(scale(A, 2.5)), 2.5 * D)
    np.testing.assert_allclose(dense(scale_diagonal(A, 3.0)),
                               offd + 3.0 * np.diag(np.diag(D)))
    np.testing.assert_allclose(dense(scale_off_diagonal(A, 0.5)),
                               0.5 * offd + np.diag(np.diag(D)))
    # AddScalar acts on STORED entries only (reference semantics)
    mask = (np.abs(D) > 0)
    np.testing.assert_allclose(dense(add_scalar(A, 1.0)), D + mask * 1.0)
    np.testing.assert_allclose(dense(add_scalar_diagonal(A, -2.0)),
                               D - 2.0 * np.eye(A.shape[0]))
    np.testing.assert_allclose(
        dense(add_scalar_off_diagonal(A, 1.0)),
        D + (mask - np.eye(A.shape[0])) * 1.0)
    # Compress drops small off-diagonals, keeps the diagonal
    Cm = compress(A, 1.5)
    np.testing.assert_allclose(dense(Cm), np.diag(np.diag(D)) +
                               np.where(np.abs(offd) > 1.5, offd, 0.0))
    np.testing.assert_allclose(extract_column_vector(A, 3), D[:, 3])
    np.testing.assert_allclose(extract_row_vector(A, 7), D[7, :])


def test_replace_vectors_and_create_from_map(rng):
    import scipy.sparse as sp
    from rocalution_tpu.ops.extract import (create_from_map,
                                            replace_column_vector,
                                            replace_row_vector)

    A = rt.laplacian_2d(5)
    n = A.shape[0]

    def dense(M):
        dd, ii, pp = M.numpy_triplet()
        return sp.csr_matrix((dd, ii, pp), shape=M.shape).toarray()

    D = dense(A)
    vec = np.zeros(n)
    vec[[2, 7, 11]] = [1.5, -2.0, 3.0]
    Dc = D.copy(); Dc[:, 4] = vec
    np.testing.assert_allclose(dense(replace_column_vector(A, 4, vec)), Dc)
    Dr = D.copy(); Dr[4, :] = vec
    np.testing.assert_allclose(dense(replace_row_vector(A, 4, vec)), Dr)

    fmap = np.array([0, -1, 2, 1, 2], np.int32)
    R, P = create_from_map(fmap, 5, 3)
    DR = dense(R)
    assert DR.shape == (3, 5)
    expect = np.zeros((3, 5))
    expect[0, 0] = expect[2, 2] = expect[1, 3] = expect[2, 4] = 1
    np.testing.assert_allclose(DR, expect)
    np.testing.assert_allclose(dense(P), expect.T)
