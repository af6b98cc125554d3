"""Native (C++) setup-phase kernels.

Reference parity: rocALUTION's host backend is C++ (src/base/host/*); the
sequential factorization sweeps and file parsing live there. Here the same
split holds: JAX/XLA own the device compute path, and this module is
the native runtime layer for the sequential host work — compiled once from
csrc/rocalution_tpu_native.cpp with g++ and bound via ctypes (no pybind11
in this environment).

Every entry point has a pure-numpy fallback in ops/factorize — `available()`
gates dispatch, mirroring the reference's capability-flag design
(base_matrix.hpp bool returns → host fallback).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc",
                    "rocalution_tpu_native.cpp")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    cache_dir = os.environ.get(
        "ROCALUTION_TPU_NATIVE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "rocalution_tpu"),
    )
    os.makedirs(cache_dir, exist_ok=True)
    lib_path = os.path.join(cache_dir, f"native_{tag}.so")
    if not os.path.exists(lib_path):
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", src, "-o", lib_path + ".tmp"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(lib_path + ".tmp", lib_path)
        except Exception as e:  # compiler missing / failed: fall back
            print(f"rocalution_tpu: native build failed ({e}); "
                  "using numpy fallbacks", file=sys.stderr)
            return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.rt_ilu0_csr.restype = ctypes.c_int64
    lib.rt_ilu0_csr.argtypes = [ctypes.c_int64, i64p, i32p, f64p]
    lib.rt_ic0_csr.restype = ctypes.c_int64
    lib.rt_ic0_csr.argtypes = [ctypes.c_int64, i64p, i32p, f64p]
    lib.rt_ilut_csr.restype = ctypes.c_int64
    lib.rt_ilut_csr.argtypes = [
        ctypes.c_int64, i64p, i32p, f64p, ctypes.c_double, ctypes.c_int64,
        i32p, f64p, i64p, i32p, f64p, i64p,
    ]
    lib.rt_mtx_body.restype = ctypes.c_int
    lib.rt_mtx_body.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        i64p, i64p, f64p, f64p,
    ]
    lib.rt_greedy_aggregate.restype = ctypes.c_int64
    lib.rt_greedy_aggregate.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
    lib.rt_pairwise_match.restype = ctypes.c_int64
    lib.rt_pairwise_match.argtypes = [
        ctypes.c_int64, i64p, i32p, f64p, ctypes.c_double, i64p, i64p,
    ]
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.rt_rs_coarsening.restype = ctypes.c_int64
    lib.rt_rs_coarsening.argtypes = [
        ctypes.c_int64, i64p, i32p, i64p, i32p, ctypes.c_int, i8p,
    ]
    i64pp = ctypes.POINTER(i64p)
    i32pp = ctypes.POINTER(i32p)
    f64pp = ctypes.POINTER(f64p)
    lib.rt_free.restype = None
    lib.rt_free.argtypes = [ctypes.c_void_p]
    lib.rt_spgemm_csr.restype = ctypes.c_int64
    lib.rt_spgemm_csr.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f64p, i64p, i32p, f64p,
        i64pp, i32pp, f64pp,
    ]
    lib.rt_sa_galerkin.restype = ctypes.c_int64
    lib.rt_sa_galerkin.argtypes = [
        ctypes.c_int64, i64p, i32p, f64p, i64p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        i64pp, i32pp, f64pp, i64pp, i32pp, f64pp, i64pp, i32pp, f64pp, i64p,
    ]
    lib.rt_strength_graph.restype = ctypes.c_int64
    lib.rt_strength_graph.argtypes = [
        ctypes.c_int64, i64p, i32p, f64p, ctypes.c_double, i64pp, i32pp,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        if os.environ.get("ROCALUTION_TPU_NO_NATIVE") != "1":
            _LIB = _build_and_load()
    return _LIB


def available() -> bool:
    return get_lib() is not None


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def ilu0_inplace(indptr: np.ndarray, cols: np.ndarray,
                 data: np.ndarray) -> None:
    """In-place IKJ ILU(0); raises on zero pivot."""
    lib = get_lib()
    n = len(indptr) - 1
    rc = lib.rt_ilu0_csr(
        n, _ptr(indptr, ctypes.c_int64), _ptr(cols, ctypes.c_int32),
        _ptr(data, ctypes.c_double),
    )
    if rc != 0:
        raise ZeroDivisionError(f"ILU(0) breakdown at row {-rc - 1}")


def ic0_inplace(indptr: np.ndarray, cols: np.ndarray,
                data: np.ndarray) -> None:
    lib = get_lib()
    n = len(indptr) - 1
    rc = lib.rt_ic0_csr(
        n, _ptr(indptr, ctypes.c_int64), _ptr(cols, ctypes.c_int32),
        _ptr(data, ctypes.c_double),
    )
    if rc != 0:
        raise ValueError(f"IC(0) breakdown at row {-rc - 1}")


def ilut(indptr: np.ndarray, cols: np.ndarray, data: np.ndarray,
         tol: float, max_fill: int) -> Tuple:
    """ILUT(t, m); returns (l_rows, l_cols, l_vals, u_rows, u_cols, u_vals)
    in COO form (L strict lower — unit diagonal NOT included)."""
    lib = get_lib()
    n = len(indptr) - 1
    l_cols = np.zeros(n * max_fill, np.int32)
    l_vals = np.zeros(n * max_fill, np.float64)
    l_cnt = np.zeros(n, np.int64)
    u_cols = np.zeros(n * (max_fill + 1), np.int32)
    u_vals = np.zeros(n * (max_fill + 1), np.float64)
    u_cnt = np.zeros(n, np.int64)
    rc = lib.rt_ilut_csr(
        n, _ptr(indptr, ctypes.c_int64), _ptr(cols, ctypes.c_int32),
        _ptr(data, ctypes.c_double), float(tol), int(max_fill),
        _ptr(l_cols, ctypes.c_int32), _ptr(l_vals, ctypes.c_double),
        _ptr(l_cnt, ctypes.c_int64),
        _ptr(u_cols, ctypes.c_int32), _ptr(u_vals, ctypes.c_double),
        _ptr(u_cnt, ctypes.c_int64),
    )
    if rc != 0:
        raise ZeroDivisionError(f"ILUT breakdown at row {-rc - 1}")

    def unpack(ccols, cvals, cnt, stride):
        rows = np.repeat(np.arange(n), cnt)
        mask = (np.arange(stride)[None, :] < cnt[:, None]).ravel()
        return rows, ccols.reshape(n, stride).ravel()[mask], \
            cvals.reshape(n, stride).ravel()[mask]

    lr, lc, lv = unpack(l_cols, l_vals, l_cnt, max_fill)
    ur, uc, uv = unpack(u_cols, u_vals, u_cnt, max_fill + 1)
    return lr, lc, lv, ur, uc, uv


def greedy_aggregate(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Vanek greedy aggregation over a strength graph (native sweep —
    reference AMGGreedyAggregate). Returns agg ids in [0, n_agg)."""
    lib = get_lib()
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    agg = np.full(n, -1, np.int64)
    lib.rt_greedy_aggregate(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(agg, ctypes.c_int64),
    )
    return agg


def pairwise_match(indptr: np.ndarray, indices: np.ndarray,
                   data: np.ndarray, beta: float,
                   order: np.ndarray) -> Tuple[np.ndarray, int]:
    """One Notay pairwise matching pass (native sweep). Returns
    (new_id, n_pairs)."""
    lib = get_lib()
    m = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    order = np.ascontiguousarray(order, np.int64)
    new_id = np.full(m, -1, np.int64)
    na = lib.rt_pairwise_match(
        m, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(data, ctypes.c_double), float(beta),
        _ptr(order, ctypes.c_int64), _ptr(new_id, ctypes.c_int64),
    )
    return new_id, int(na)


def rs_coarsening(s_indptr, s_indices, st_indptr, st_indices,
                  cf_init: np.ndarray, second_pass: bool = True) -> np.ndarray:
    """Classical greedy Ruge-Stueben C/F splitting (native sweep).
    cf_init: int8, 0 undecided / 2 pre-forced F. Returns cf (1=C, 2=F)."""
    lib = get_lib()
    n = len(s_indptr) - 1
    s_indptr = np.ascontiguousarray(s_indptr, np.int64)
    s_indices = np.ascontiguousarray(s_indices, np.int32)
    st_indptr = np.ascontiguousarray(st_indptr, np.int64)
    st_indices = np.ascontiguousarray(st_indices, np.int32)
    cf = np.ascontiguousarray(cf_init, np.int8).copy()
    lib.rt_rs_coarsening(
        n, _ptr(s_indptr, ctypes.c_int64), _ptr(s_indices, ctypes.c_int32),
        _ptr(st_indptr, ctypes.c_int64), _ptr(st_indices, ctypes.c_int32),
        int(second_pass), _ptr(cf, ctypes.c_int8),
    )
    return cf


def mtx_body(path: str, header_offset: int, nnz: int,
             ncols_per_line: int) -> Tuple:
    lib = get_lib()
    rows = np.zeros(nnz, np.int64)
    cols = np.zeros(nnz, np.int64)
    re = np.zeros(nnz, np.float64)
    im = np.zeros(nnz, np.float64) if ncols_per_line == 4 else None
    rc = lib.rt_mtx_body(
        path.encode(), int(header_offset), int(nnz), int(ncols_per_line),
        _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        _ptr(re, ctypes.c_double),
        _ptr(im, ctypes.c_double) if im is not None
        else ctypes.cast(None, ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise IOError(f"mtx body parse failed ({rc}) for {path}")
    return rows, cols, re, im


def _take(cptr, n, nptype):
    """Copy a callee-malloc'd buffer into a numpy array and free it."""
    lib = get_lib()
    out = np.empty(int(n), nptype)
    if n:
        ctypes.memmove(out.ctypes.data, cptr, int(n) * out.itemsize)
    lib.rt_free(cptr)
    return out


def _csr_args(indptr, indices, data):
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    return (indptr, indices, data,
            _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
            _ptr(data, ctypes.c_double))


def spgemm(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
           ncols: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """C = A @ B on host CSR triplets (native two-thread Gustavson, sorted
    rows — the reference's csrgemm analog). Returns (indptr, indices, data)
    of C with `len(a_indptr)-1` rows and `ncols` columns."""
    lib = get_lib()
    n = len(a_indptr) - 1
    ah = _csr_args(a_indptr, a_indices, a_data)
    bh = _csr_args(b_indptr, b_indices, b_data)
    cp = ctypes.POINTER(ctypes.c_int64)()
    cc = ctypes.POINTER(ctypes.c_int32)()
    cv = ctypes.POINTER(ctypes.c_double)()
    nnz = lib.rt_spgemm_csr(n, int(ncols), *ah[3:], *bh[3:],
                            ctypes.byref(cp), ctypes.byref(cc),
                            ctypes.byref(cv))
    ptr = _take(cp, n + 1, np.int64)
    col = _take(cc, nnz, np.int32)
    val = _take(cv, nnz, np.float64)
    return ptr, col, val


def sa_galerkin(indptr, indices, data, agg, n_agg: int, eps: float,
                omega: float, lumping: bool):
    """Fused smoothed-aggregation level build: P = (I - w D^-1 A_f) T,
    R = P^T, Ac = R A P, all in one native call (analog of the reference's
    device SA setup kernels, hip_matrix_csr.cpp AMGSmoothedAggregation +
    MatMatMult). Returns ((p_ptr,p_col,p_val), (r_ptr,r_col,r_val),
    (c_ptr,c_col,c_val))."""
    lib = get_lib()
    n = len(indptr) - 1
    ah = _csr_args(indptr, indices, data)
    agg = np.ascontiguousarray(agg, np.int64)
    outs = [ctypes.POINTER(ctypes.c_int64)(),
            ctypes.POINTER(ctypes.c_int32)(),
            ctypes.POINTER(ctypes.c_double)(),
            ctypes.POINTER(ctypes.c_int64)(),
            ctypes.POINTER(ctypes.c_int32)(),
            ctypes.POINTER(ctypes.c_double)(),
            ctypes.POINTER(ctypes.c_int64)(),
            ctypes.POINTER(ctypes.c_int32)(),
            ctypes.POINTER(ctypes.c_double)()]
    nnz3 = np.zeros(3, np.int64)
    rc = lib.rt_sa_galerkin(
        n, *ah[3:], _ptr(agg, ctypes.c_int64), int(n_agg), float(eps),
        float(omega), int(bool(lumping)),
        *[ctypes.byref(o) for o in outs], _ptr(nnz3, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"rt_sa_galerkin failed ({rc})")
    P = (_take(outs[0], n + 1, np.int64), _take(outs[1], nnz3[0], np.int32),
         _take(outs[2], nnz3[0], np.float64))
    R = (_take(outs[3], n_agg + 1, np.int64),
         _take(outs[4], nnz3[1], np.int32),
         _take(outs[5], nnz3[1], np.float64))
    Ac = (_take(outs[6], n_agg + 1, np.int64),
          _take(outs[7], nnz3[2], np.int32),
          _take(outs[8], nnz3[2], np.float64))
    return P, R, Ac


def strength_graph(indptr, indices, data, eps: float):
    """SA strength pattern |a_ij| >= eps sqrt(|a_ii a_jj|) (off-diagonal
    only): returns (indptr, indices) of the int-pattern graph."""
    lib = get_lib()
    n = len(indptr) - 1
    ah = _csr_args(indptr, indices, data)
    sp_ = ctypes.POINTER(ctypes.c_int64)()
    sc_ = ctypes.POINTER(ctypes.c_int32)()
    nnz = lib.rt_strength_graph(n, *ah[3:], float(eps), ctypes.byref(sp_),
                                ctypes.byref(sc_))
    ptr = _take(sp_, n + 1, np.int64)
    col = _take(sc_, nnz, np.int32)
    return ptr, col
