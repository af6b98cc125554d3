"""Real-matrix fixture tests: solve matrices read
from FILES end-to-end to 1e-8 — the reference's canonical smoke flow
(CG on gr_30_30.mtx, README.md:66-73, testing_cg.hpp:28-38) — plus a
golden rocsparseio file whose bytes were written directly from the spec
(rocsparseio.hpp:761-2128), so the interop test is not self-referential.
"""

import os

import numpy as np
import pytest

import rocalution_tpu as rt
from rocalution_tpu.io.rocsparseio import read_rocsparseio, write_rocsparseio

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def test_gr_30_30_like_cg_ic_to_1e8():
    """File -> CG+IC(0) -> 1e-8 on the 900x900 9-point grid Laplacian
    (the gr_30_30 class; symmetric MTX exercises symmetric expansion)."""
    A = rt.io.read_mtx(os.path.join(FIX, "gr_30_30_like.mtx"))
    assert A.shape == (900, 900)
    assert A.nnz == 7744          # matches the NIST gr_30_30 pattern size
    b = np.asarray(rt.spmv(A, np.ones(A.shape[0])))
    from rocalution_tpu.precond import ic

    x, info = rt.cg(A, b, M=ic(A), rel_tol=1e-8, max_iter=500)
    assert int(info.status) in (1, 2)
    r = b - np.asarray(rt.spmv(A, x))
    assert np.linalg.norm(r) <= 1.1e-8 * np.linalg.norm(b)
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-6


def test_convdiff_gmres_ilu_to_1e8():
    """File -> GMRES(30)+ILU(0) -> 1e-8 on a nonsymmetric matrix."""
    A = rt.io.read_mtx(os.path.join(FIX, "convdiff_24.mtx"))
    b = np.asarray(rt.spmv(A, np.ones(A.shape[0])))
    from rocalution_tpu.precond import ilu

    x, info = rt.gmres(A, b, M=ilu(A, 0), basis_size=30, rel_tol=1e-8,
                       max_iter=500)
    assert int(info.status) in (1, 2)
    r = b - np.asarray(rt.spmv(A, x))
    assert np.linalg.norm(r) <= 1.1e-8 * np.linalg.norm(b)


def test_golden_rocsparseio_read():
    """Parse a byte-golden reference-layout file (written by struct.pack
    from the spec, not by this library's writer)."""
    A = read_rocsparseio(os.path.join(FIX, "golden_csr.rocsparseio"))
    assert A.shape == (4, 5)
    d, i, p = A.numpy_triplet()
    np.testing.assert_array_equal(p, [0, 2, 3, 3, 5])
    np.testing.assert_array_equal(i, [0, 3, 1, 2, 4])
    np.testing.assert_array_equal(d, [1.5, -2.0, 3.25, 0.5, 7.0])


def test_golden_rocsparseio_roundtrip_bytes(tmp_path):
    """Writing the golden matrix back produces a byte-compatible payload
    (same scalars and arrays; only the free-form name field differs)."""
    path = os.path.join(FIX, "golden_csr.rocsparseio")
    A = read_rocsparseio(path)
    out = tmp_path / "rt.rocsparseio"
    write_rocsparseio(str(out), A, name="golden")
    with open(path, "rb") as f:
        want = f.read()
    with open(out, "rb") as f:
        got = f.read()
    assert got == want            # byte-identical including the name
