"""rocsparseio-compatible binary container reader/writer.

Interoperability with files produced by the reference's versioned binary
sparse-matrix container (src/utils/rocsparseio.{h,hpp,cpp}; used by
LocalMatrix::WriteFileCSR/ReadFileCSR since rocALUTION 3.0, CHANGELOG.md).
The byte layout below is dictated by that file format:

* file header: 16 bytes = two little-endian uint64 words holding the
  zero-padded ASCII string ``ROCSPARSEIO.<major>`` (open(), version guard);
* each stored object starts with a 512-byte name field
  (``rocsparseio_string``, rocsparseio.h:47);
* CSX object (format enum 2, rocsparseio.h:116): 9 uint64 scalars
  [format, direction, m, n, nnz, ptr_type, ind_type, data_type, base]
  then three arrays (ptr: m+1 or n+1 by direction; ind: nnz; data: nnz);
* COO object (format enum 4): 8 uint64 scalars
  [format, m, n, nnz, row_ind_type, col_ind_type, data_type, base]
  then three arrays (row_ind, col_ind, data: nnz each);
* MCSX object (format enum 8, fwrite_sparse_mcsx rocsparseio.hpp:1891):
  name field FIRST, then 9 uint64 scalars like CSX, then ptr/ind/data
  arrays — the payload is rocALUTION's modified-CSR layout: val[0..m) is
  the diagonal, ptr[i] >= m indexes the off-diagonal run of row i in the
  same val/ind arrays (host_matrix_mcsr.cpp:409-419 WriteFileRSIO);
* DENSE VECTOR object (format enum 0, fwrite_dense_vector
  rocsparseio.hpp:805): scalars [format, data_type, nmemb] come BEFORE
  the 512-byte name, and the data follows RAW (no array prefix) — the
  one object whose layout differs from the others;
* every other array is prefixed by two uint64 words (element size, count)
  followed by the raw elements (fwrite_array, rocsparseio.hpp:761-769).

Type enum (rocsparseio.h:106-112): 0=int32 1=int64 2=f32 3=f64
4=complex<f32> 5=complex<f64> 6=int8.
"""

from __future__ import annotations

import struct

import numpy as np

from ..formats import CSR

VERSION_MAJOR = 1

_FMT_DENSE_VECTOR = 0
_FMT_SPARSE_CSX = 2
_FMT_SPARSE_COO = 4
_FMT_SPARSE_MCSX = 8

_TYPE_TO_DTYPE = {
    0: np.dtype("<i4"), 1: np.dtype("<i8"),
    2: np.dtype("<f4"), 3: np.dtype("<f8"),
    4: np.dtype("<c8"), 5: np.dtype("<c16"),
    6: np.dtype("i1"),
}
_DTYPE_TO_TYPE = {v: k for k, v in _TYPE_TO_DTYPE.items()}

_NAME_BYTES = 512


def _header_words() -> bytes:
    s = f"ROCSPARSEIO.{VERSION_MAJOR}".encode()
    return s + b"\0" * (16 - len(s))


def _read_u64(f, n=1):
    raw = f.read(8 * n)
    if len(raw) != 8 * n:
        raise ValueError("rocsparseio: truncated file")
    vals = struct.unpack(f"<{n}Q", raw)
    return vals[0] if n == 1 else vals


def _write_u64(f, *vals):
    f.write(struct.pack(f"<{len(vals)}Q", *vals))


def _read_array(f, dtype):
    size, nmemb = _read_u64(f, 2)
    if size != dtype.itemsize:
        raise ValueError(
            f"rocsparseio: array element size {size} != dtype {dtype}"
        )
    a = np.fromfile(f, dtype=dtype, count=nmemb)
    if len(a) != nmemb:
        raise ValueError("rocsparseio: truncated array")
    return a


def _write_array(f, a):
    a = np.ascontiguousarray(a)
    _write_u64(f, a.dtype.itemsize, a.size)
    a.tofile(f)


def read_rocsparseio(path: str):
    """Read a reference-produced rocsparseio file: CSX/COO → CSR pytree,
    MCSX → MCSR pytree, dense vector → numpy array (reference:
    LocalMatrix::ReadFileCSR / HostMatrixMCSR::ReadFileRSIO /
    LocalVector binary IO via rocsparseio).

    Object-kind detection: matrix objects store the 512-byte name field
    first, the dense-vector object stores its format word first
    (rocsparseio.hpp:805 vs :1891) — a leading u64 in 0..8 can only be a
    format word (a name would need to START with that control byte)."""
    with open(path, "rb") as f:
        if f.read(16) != _header_words():
            raise ValueError(f"{path}: not a rocsparseio v{VERSION_MAJOR} file")
        first = _read_u64(f)
        if first == _FMT_DENSE_VECTOR:
            # layout: [format, type, nmemb], name, raw data
            dat_t, nmemb = _read_u64(f, 2)
            f.read(_NAME_BYTES)
            dtype = _TYPE_TO_DTYPE[int(dat_t)]
            v = np.fromfile(f, dtype=dtype, count=int(nmemb))
            if len(v) != int(nmemb):
                raise ValueError(f"{path}: truncated dense vector")
            return v
        f.seek(16)
        f.read(_NAME_BYTES)  # object name (informational)
        fmt = _read_u64(f)
        if fmt == _FMT_SPARSE_CSX:
            direction, m, n, nnz, ptr_t, ind_t, dat_t, base = _read_u64(f, 8)
            ptr = _read_array(f, _TYPE_TO_DTYPE[int(ptr_t)])
            ind = _read_array(f, _TYPE_TO_DTYPE[int(ind_t)]) - int(base)
            data = _read_array(f, _TYPE_TO_DTYPE[int(dat_t)])
            # cross-check stored scalars vs actual array counts so an
            # internally inconsistent file errors instead of yielding a
            # malformed CSR
            nptr_want = int(n) + 1 if direction == 1 else int(m) + 1
            if len(ptr) != nptr_want or len(ind) != int(nnz) \
                    or len(data) != int(nnz):
                raise ValueError(
                    f"{path}: inconsistent CSX object: |ptr|={len(ptr)} "
                    f"(want {nptr_want}), |ind|={len(ind)}, "
                    f"|data|={len(data)}, nnz={int(nnz)}"
                )
            if direction == 1:  # CSC: transpose to CSR
                from scipy.sparse import csc_matrix

                A = csc_matrix((data, ind, ptr - int(base)),
                               shape=(m, n)).tocsr()
                return CSR.from_arrays(A.data, A.indices, A.indptr, (m, n))
            return CSR.from_arrays(data, ind, ptr - int(base),
                                   (int(m), int(n)))
        if fmt == _FMT_SPARSE_COO:
            m, n, nnz, row_t, col_t, dat_t, base = _read_u64(f, 7)
            rows = _read_array(f, _TYPE_TO_DTYPE[int(row_t)]) - int(base)
            cols = _read_array(f, _TYPE_TO_DTYPE[int(col_t)]) - int(base)
            data = _read_array(f, _TYPE_TO_DTYPE[int(dat_t)])
            if not (len(rows) == len(cols) == len(data) == int(nnz)):
                raise ValueError(
                    f"{path}: inconsistent COO object: |row|={len(rows)}, "
                    f"|col|={len(cols)}, |data|={len(data)}, nnz={int(nnz)}"
                )
            order = np.lexsort((cols, rows))
            indptr = np.zeros(int(m) + 1, np.int64)
            np.add.at(indptr, rows + 1, 1)
            indptr = np.cumsum(indptr)
            return CSR.from_arrays(data[order], cols[order], indptr,
                                   (int(m), int(n)))
        if fmt == _FMT_SPARSE_MCSX:
            from ..formats.mcsr import MCSR

            direction, m, n, nnz, ptr_t, ind_t, dat_t, base = _read_u64(f, 8)
            ptr = (_read_array(f, _TYPE_TO_DTYPE[int(ptr_t)])
                   .astype(np.int64) - int(base))
            ind = (_read_array(f, _TYPE_TO_DTYPE[int(ind_t)])
                   .astype(np.int64) - int(base))
            data = _read_array(f, _TYPE_TO_DTYPE[int(dat_t)])
            m, n = int(m), int(n)
            nptr_want = (n if direction == 1 else m) + 1
            if len(ptr) != nptr_want or len(ind) != int(nnz) \
                    or len(data) != int(nnz):
                raise ValueError(f"{path}: inconsistent MCSX object")
            # modified-CSR payload: val[0..m) = diagonal; ptr (with
            # ptr[0] == m) indexes the off-diagonal runs in the tail
            import jax.numpy as jnp

            start = int(ptr[0])
            if direction == 1:
                # MCSC (column direction): same diagonal (square only),
                # off-diagonal runs are per COLUMN — normalize to row
                # direction (accept both directions instead of
                # rejecting)
                if m != n:
                    raise ValueError(
                        f"{path}: non-square MCSC object unsupported")
                from scipy.sparse import csc_matrix

                diag = data[:n]
                offc = csc_matrix(
                    (data[start:], ind[start:], ptr - start),
                    shape=(m, n)).tocsr()
                offc.sort_indices()
                offd = CSR.from_arrays(offc.data, offc.indices,
                                       offc.indptr, (m, n))
                return MCSR(diag=jnp.asarray(diag), offd=offd,
                            shape=(m, n))
            diag = data[:m]
            offd = CSR.from_arrays(data[start:], ind[start:],
                                   ptr - start, (m, n))
            return MCSR(diag=jnp.asarray(diag), offd=offd, shape=(m, n))
        raise ValueError(f"{path}: unsupported rocsparseio format {fmt}")


def _name_field(name: str) -> bytes:
    nm = name.encode()[: _NAME_BYTES - 1]
    return nm + b"\0" * (_NAME_BYTES - len(nm))


def write_rocsparseio(path: str, A, name: str = "rocalution_tpu") -> None:
    """Write a matrix as a rocsparseio object the reference can read:
    MCSR pytrees become MCSX objects (HostMatrixMCSR::WriteFileRSIO
    layout), everything else a CSX object (LocalMatrix::WriteFileCSR →
    rocsparseio_write_sparse_csx)."""
    from ..formats import MCSR as _MCSR
    from ..formats import to_csr
    from ..formats.base import get_host

    if isinstance(A, _MCSR):
        return _write_mcsx(path, A, name)
    csr = to_csr(A)
    data = np.asarray(get_host(csr, "data"))
    ind = np.asarray(get_host(csr, "indices"))
    ptr = np.asarray(get_host(csr, "indptr"))
    m, n = csr.shape
    # index width follows the values (reference type enum 1 = int64): int32
    # would silently wrap for nnz or dims >= 2^31
    itype = "<i8" if max(m, n, int(ptr[-1]) if len(ptr) else 0) >= 2**31 \
        else "<i4"
    ind = ind.astype(itype)
    ptr = ptr.astype(itype)
    dt = _DTYPE_TO_TYPE.get(data.dtype.newbyteorder("<"))
    if dt is None:
        data = data.astype("<f8")
        dt = 3
    with open(path, "wb") as f:
        f.write(_header_words())
        f.write(_name_field(name))
        _write_u64(f, _FMT_SPARSE_CSX, 0, m, n, len(data),
                   _DTYPE_TO_TYPE[ptr.dtype], _DTYPE_TO_TYPE[ind.dtype],
                   dt, 0)
        _write_array(f, ptr)
        _write_array(f, ind)
        _write_array(f, data)


def _write_mcsx(path: str, A, name: str) -> None:
    """MCSX object (fwrite_sparse_mcsx, rocsparseio.hpp:1891): modified-
    CSR payload — val[0..m) diagonal, ptr[i] = m + offd_indptr[i]."""
    from ..formats.base import get_host

    diag = np.asarray(get_host(A, "diag") if getattr(A, "_host_cache", None)
                      else A.diag)
    od, oi, op = A.offd.numpy_triplet()
    m, n = A.shape
    data = np.concatenate([diag, od])
    # ind[0..m) is unused padding in the reference layout; zeros are safe
    ind = np.concatenate([np.zeros(m, np.int64), oi])
    ptr = (op + m).astype(np.int64)
    nnz = len(data)
    itype = "<i8" if max(m, n, nnz) >= 2**31 else "<i4"
    ind = ind.astype(itype)
    ptr = ptr.astype(itype)
    dt = _DTYPE_TO_TYPE.get(data.dtype.newbyteorder("<"))
    if dt is None:
        data = data.astype("<f8")
        dt = 3
    with open(path, "wb") as f:
        f.write(_header_words())
        f.write(_name_field(name))
        _write_u64(f, _FMT_SPARSE_MCSX, 0, m, n, nnz,
                   _DTYPE_TO_TYPE[ptr.dtype], _DTYPE_TO_TYPE[ind.dtype],
                   dt, 0)
        _write_array(f, ptr)
        _write_array(f, ind)
        _write_array(f, data)


def write_vector_rocsparseio(path: str, v,
                             name: str = "rocalution_tpu") -> None:
    """Dense-vector object (fwrite_dense_vector, rocsparseio.hpp:805 —
    NOTE its scalars precede the name field and the data is raw);
    reference: LocalVector binary IO through rocsparseio."""
    v = np.ascontiguousarray(np.asarray(v))
    dt = _DTYPE_TO_TYPE.get(v.dtype.newbyteorder("<"))
    if dt is None:
        v = v.astype("<f8")
        dt = 3
    with open(path, "wb") as f:
        f.write(_header_words())
        _write_u64(f, _FMT_DENSE_VECTOR, dt, v.size)
        f.write(_name_field(name))
        v.tofile(f)


def read_vector_rocsparseio(path: str) -> np.ndarray:
    """Read a dense-vector object (see write_vector_rocsparseio)."""
    v = read_rocsparseio(path)
    if not isinstance(v, np.ndarray):
        raise ValueError(f"{path}: not a dense-vector object")
    return v
