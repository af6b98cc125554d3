"""Stencil operator and IO round-trip tests (reference: local_stencil tests,
host_io MTX/binary round trips, multinode file layout)."""

import numpy as np
import pytest

import rocalution_tpu as rt
from rocalution_tpu.io import (read_csr, read_mtx, read_vector, write_csr,
                               write_global_csr, write_mtx, write_vector)


def test_stencil_matches_matrix(rng):
    st = rt.laplace2d_stencil(12)
    A = rt.laplacian_2d(12)
    x = rng.standard_normal(144)
    np.testing.assert_allclose(
        np.asarray(rt.spmv(st, x)), np.asarray(rt.spmv(A, x)), atol=1e-12
    )


def test_stencil_to_csr(rng):
    st = rt.laplace3d_stencil(5)
    A = st.to_csr()
    x = rng.standard_normal(125)
    np.testing.assert_allclose(
        np.asarray(rt.spmv(st, x)), np.asarray(rt.spmv(A, x)), atol=1e-12
    )


def test_stencil_cg(rng):
    st = rt.laplace2d_stencil(10)
    ones = np.ones(100)
    b = np.asarray(rt.spmv(st, ones))
    x, info = rt.cg(st, b, rel_tol=1e-10)
    assert bool(info.converged)
    assert np.linalg.norm(np.asarray(x) - ones) < 1e-6


def test_mtx_roundtrip(tmp_path, rng):
    A = rt.utils.generators.random_spd(30, density=0.1, seed=4)
    p = str(tmp_path / "m.mtx")
    write_mtx(p, A)
    B = read_mtx(p)
    np.testing.assert_allclose(
        np.asarray(A.to_dense()), np.asarray(B.to_dense()), rtol=1e-12
    )


def test_binary_roundtrip(tmp_path):
    A = rt.laplacian_2d(9)
    p = str(tmp_path / "m")
    write_csr(p, A)
    B = read_csr(p)
    np.testing.assert_allclose(
        np.asarray(A.to_dense()), np.asarray(B.to_dense()), atol=0
    )


def test_vector_io(tmp_path, rng):
    v = rng.standard_normal(64)
    pb = str(tmp_path / "v")
    write_vector(pb, v)
    np.testing.assert_allclose(read_vector(pb), v, atol=0)
    pa = str(tmp_path / "v.txt")
    write_vector(pa, v, binary=False)
    np.testing.assert_allclose(read_vector(pa, binary=False), v, rtol=1e-12)


def test_global_layout_roundtrip(tmp_path):
    """write_global_csr -> read_global_csr -> dist_solve produces identical
    iterates (reference: samples/global-io_mpi.cpp flow — write the triad,
    read it back, solve)."""
    from rocalution_tpu.io import read_global_csr
    from rocalution_tpu.parallel import dist_solve, distribute_csr

    A = rt.laplacian_2d(16)
    Ag = distribute_csr(A, 4)
    prefix = str(tmp_path / "dist")
    write_global_csr(prefix, Ag)
    import json
    import os

    meta = json.load(open(prefix + ".pm.json"))
    assert meta["nparts"] == 4
    for p in range(4):
        assert os.path.exists(f"{prefix}.matrix.rank.{p}.npz")
        assert os.path.exists(f"{prefix}.pm.rank.{p}.npz")

    Ag2 = read_global_csr(prefix)
    assert Ag2.mode == Ag.mode and Ag2.shifts == Ag.shifts
    for f in ("int_data", "int_cols", "ghost_data", "ghost_cols",
              "send_idx", "recv_idx", "send_off"):
        np.testing.assert_array_equal(
            np.asarray(getattr(Ag2, f)), np.asarray(getattr(Ag, f))
        )

    b = np.ones(A.shape[0])
    x1, info1 = dist_solve(rt.cg, Ag, b, rel_tol=1e-10, max_iter=400)
    x2, info2 = dist_solve(rt.cg, Ag2, b, rel_tol=1e-10, max_iter=400)
    assert int(info1.iterations) == int(info2.iterations)
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))


def test_rocsparseio_roundtrip(tmp_path):
    """rocsparseio-compatible container: byte layout validated against the
    reference implementation itself (a file written by the reference's
    rocsparseio.cpp parses identically; a file written here is read back by
    the reference's rocsparseiox_read_sparse_csx — verified during
    development). Reference: src/utils/rocsparseio.{h,hpp,cpp}."""
    from rocalution_tpu.io import read_rocsparseio, write_rocsparseio

    A = rt.laplacian_2d(9)
    path = str(tmp_path / "m.rsio")
    write_rocsparseio(path, A)
    B = read_rocsparseio(path)
    d1, i1, p1 = A.numpy_triplet()
    d2, i2, p2 = B.numpy_triplet()
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=0)
    assert A.shape == B.shape


def test_rocsparseio_reference_layout(tmp_path):
    """Parse a byte-exact reference-layout file assembled by hand (header,
    512-byte name, 9 uint64 scalars, size/count-prefixed arrays)."""
    import struct

    from rocalution_tpu.io import read_rocsparseio

    path = str(tmp_path / "ref.rsio")
    ptr = np.array([0, 2, 3, 5], "<i4")
    ind = np.array([0, 2, 1, 0, 2], "<i4")
    val = np.array([4.0, -1.0, 3.0, -1.5, 5.0], "<f8")
    with open(path, "wb") as f:
        f.write(b"ROCSPARSEIO.1" + b"\0" * 3)
        f.write(b"fixture" + b"\0" * 505)
        f.write(struct.pack("<9Q", 2, 0, 3, 3, 5, 0, 0, 3, 0))
        for a in (ptr, ind, val):
            f.write(struct.pack("<2Q", a.dtype.itemsize, a.size))
            f.write(a.tobytes())
    B = read_rocsparseio(path)
    d, i, p = B.numpy_triplet()
    np.testing.assert_array_equal(np.asarray(p), ptr)
    np.testing.assert_array_equal(np.asarray(i), ind)
    np.testing.assert_allclose(np.asarray(d), val, atol=0)


def test_bench_regression_script(tmp_path):
    """scripts/bench_regression.py (reference:
    scripts/rocalution-bench-regression.py % tolerance compare)."""
    import json
    import subprocess
    import sys

    old = tmp_path / "old.json"
    new = tmp_path / "new.json"
    old.write_text(json.dumps({
        "metric": "spmv_csr_f32_bandwidth", "value": 100.0,
        "detail": {"axpy_gbps": 3000.0, "cg_jacobi_65k_ms": 50.0},
    }))
    new.write_text(json.dumps({
        "metric": "spmv_csr_f32_bandwidth", "value": 99.0,
        "detail": {"axpy_gbps": 3010.0, "cg_jacobi_65k_ms": 52.0},
    }))
    import os
    script = os.path.join(os.path.dirname(__file__), "..", "scripts",
                          "bench_regression.py")
    ok = subprocess.run([sys.executable, script, str(old), str(new),
                         "--tol", "10"], capture_output=True)
    assert ok.returncode == 0, ok.stdout
    new.write_text(json.dumps({
        "metric": "spmv_csr_f32_bandwidth", "value": 50.0,
        "detail": {"axpy_gbps": 3010.0, "cg_jacobi_65k_ms": 52.0},
    }))
    bad = subprocess.run([sys.executable, script, str(old), str(new),
                          "--tol", "10"], capture_output=True)
    assert bad.returncode == 1
    assert b"REGRESSION" in bad.stdout


def test_rocsparseio_mcsx_roundtrip(tmp_path):
    """MCSX object (rocsparseio.h:122, fwrite_sparse_mcsx layout with the
    modified-CSR payload of host_matrix_mcsr.cpp:409): MCSR pytree ->
    file -> MCSR pytree, apply-equal to the source matrix."""
    import numpy as np

    import rocalution_tpu as rt
    from rocalution_tpu.formats import MCSR
    from rocalution_tpu.io import read_rocsparseio, write_rocsparseio

    A = rt.laplacian_2d(12, dtype=np.float64)
    M = rt.convert(A, "MCSR")
    assert isinstance(M, MCSR)
    path = str(tmp_path / "m.mcsx")
    write_rocsparseio(path, M)
    M2 = read_rocsparseio(path)
    assert isinstance(M2, MCSR)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    y1 = np.asarray(rt.spmv(M, x))
    y2 = np.asarray(rt.spmv(M2, x))
    np.testing.assert_allclose(y1, y2, rtol=0, atol=0)
    yref = np.asarray(rt.spmv(A, x))
    np.testing.assert_allclose(y2, yref, rtol=1e-12)


def test_rocsparseio_dense_vector_roundtrip(tmp_path):
    """Dense-vector object (rocsparseio.h:114; fwrite_dense_vector puts
    its scalars BEFORE the name and the payload raw — rocsparseio.hpp:
    805-860): write -> read bit-exact, and the reader auto-detects the
    object kind."""
    import numpy as np

    from rocalution_tpu.io import (read_rocsparseio,
                                   read_vector_rocsparseio,
                                   write_vector_rocsparseio)

    rng = np.random.default_rng(1)
    for dtype in (np.float64, np.float32, np.int32):
        v = (rng.standard_normal(257) * 100).astype(dtype)
        path = str(tmp_path / f"v_{np.dtype(dtype).name}.dv")
        write_vector_rocsparseio(path, v)
        w = read_vector_rocsparseio(path)
        assert w.dtype == v.dtype
        np.testing.assert_array_equal(v, w)
        assert isinstance(read_rocsparseio(path), np.ndarray)


def test_rocsparseio_mcsc_direction(tmp_path):
    """MCSC (COLUMN-direction MCSX, rocsparseio direction=1): previously
    rejected — now normalized to an MCSR pytree.
    A hand-built MCSC file of a known matrix must read back apply-equal."""
    import numpy as np

    import rocalution_tpu as rt
    from rocalution_tpu.formats import MCSR
    from rocalution_tpu.io import read_rocsparseio
    from rocalution_tpu.io.rocsparseio import (_FMT_SPARSE_MCSX,
                                               _header_words, _name_field,
                                               _write_array, _write_u64)

    A = rt.laplacian_2d(10, dtype=np.float64)
    d, i, p = A.numpy_triplet()
    import scipy.sparse as sp

    S = sp.csr_matrix((d, i, p), shape=A.shape)
    n = A.shape[0]
    diag = S.diagonal().copy()
    offd = (S - sp.diags(diag)).tocsc()
    offd.sort_indices()
    # MCSC payload: val[0..n) = diagonal, then off-diagonal data in
    # COLUMN runs; ptr[j] = n + offd_colptr[j]
    data = np.concatenate([diag, offd.data])
    ind = np.concatenate([np.arange(n, dtype=np.int64),
                          offd.indices.astype(np.int64)])
    ptr = (offd.indptr.astype(np.int64) + n)
    path = str(tmp_path / "m.mcsc")
    with open(path, "wb") as f:
        f.write(_header_words())
        f.write(_name_field("mcsc"))
        _write_u64(f, _FMT_SPARSE_MCSX, 1, n, n, len(data), 1, 1, 3, 0)
        _write_array(f, ptr.astype("<i8"))
        _write_array(f, ind.astype("<i8"))
        _write_array(f, data.astype("<f8"))
    M = read_rocsparseio(path)
    assert isinstance(M, MCSR)
    x = np.random.default_rng(0).standard_normal(n)
    np.testing.assert_allclose(np.asarray(rt.spmv(M, x)), S @ x,
                               rtol=1e-12)
