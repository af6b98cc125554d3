"""Binary sparse-matrix / vector container.

Reference parity: the rocsparseio versioned binary container
(src/utils/rocsparseio.{h,hpp,cpp} — format enums rocsparseio.h:66-100,
WriteFileCSR/ReadFileCSR on LocalMatrix, vector binary IO on LocalVector)
and the multi-rank file layout of docs/api-reference/multinode.rst:126-155.

Implementation: a small self-describing npz-based container
(magic + version + format tag + index/value arrays) — same capability
(versioned, typed, per-rank shardable), numpy-native speed.
"""

from __future__ import annotations

import numpy as np

from ..formats import CSR
from ..formats.base import get_host

MAGIC = "rocalution_tpu_bin"
VERSION = 1


def write_csr(path: str, A: CSR) -> None:
    """Write a CSR matrix (reference: LocalMatrix::WriteFileCSR /
    rocsparseio container)."""
    data = get_host(A, "data")
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        magic=MAGIC, version=VERSION, fmt="csr",
        nrow=A.shape[0], ncol=A.shape[1],
        data=data,
        indices=get_host(A, "indices").astype(np.int32),
        indptr=get_host(A, "indptr").astype(np.int64),
    )


def read_csr(path: str) -> CSR:
    """Read a CSR matrix (reference: LocalMatrix::ReadFileCSR)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    if str(z["magic"]) != MAGIC:
        raise ValueError(f"{path}: not a rocalution_tpu binary file")
    if str(z["fmt"]) != "csr":
        raise ValueError(f"{path}: unsupported format {z['fmt']!r}")
    return CSR.from_arrays(
        z["data"], z["indices"], z["indptr"],
        (int(z["nrow"]), int(z["ncol"])),
    )


def write_vector(path: str, v, binary: bool = True) -> None:
    """Vector IO (reference: LocalVector::WriteFile{ASCII,Binary})."""
    v = np.asarray(v)
    if binary:
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 magic=MAGIC, version=VERSION, fmt="vec", data=v)
    else:
        np.savetxt(path, v)


def read_vector(path: str, binary: bool = True) -> np.ndarray:
    if binary:
        if not path.endswith(".npz"):
            path = path + ".npz"
        z = np.load(path, allow_pickle=False)
        if str(z["magic"]) != MAGIC or str(z["fmt"]) != "vec":
            raise ValueError(f"{path}: not a rocalution_tpu vector file")
        return z["data"]
    return np.loadtxt(path)


# array fields of GlobalCSR persisted per rank, split into the interior
# file (matrix shards) and the pm file (topology shards) — mirroring the
# reference's matrix.rank.N / parallelmanager.dat.rank.N split
_GLOBAL_MAT_FIELDS = ("int_data", "int_cols", "int_rows",
                      "ghost_data", "ghost_cols", "ghost_rows")
_GLOBAL_PM_FIELDS = ("send_idx", "recv_idx", "send_off")


def write_global_csr(prefix: str, Ag) -> None:
    """Per-rank distributed matrix layout (reference: the
    `matrix.mtx.interior.rank.N` / `parallelmanager.dat.rank.N` triad +
    ghost files, docs/api-reference/multinode.rst:126-155, exercised by
    samples/global-io_mpi.cpp; ParallelManager::WriteFileASCII,
    parallel_manager.hpp:161-166).

    Writes one matrix shard file (interior + ghost) and one topology
    (ParallelManager-analog) shard file per partition, plus a JSON
    descriptor holding every static field; `read_global_csr` reconstructs
    the identical GlobalCSR."""
    import json

    P = Ag.nparts
    meta = {
        "magic": MAGIC, "version": VERSION, "nparts": P,
        "n_global": int(Ag.n_global), "n_local": int(Ag.n_local),
        "n_global_col": int(Ag.n_global_col),
        "n_local_col": int(Ag.n_local_col),
        "shape": [int(Ag.shape[0]), int(Ag.shape[1])],
        "shifts": [int(s) for s in Ag.shifts],
        "mode": Ag.mode,
        "int_nnz": [int(k) for k in Ag.int_nnz],
    }
    with open(f"{prefix}.pm.json", "w") as f:
        json.dump(meta, f)
    mat = {k: np.asarray(getattr(Ag, k)) for k in _GLOBAL_MAT_FIELDS}
    pm = {k: np.asarray(getattr(Ag, k)) for k in _GLOBAL_PM_FIELDS}
    for p in range(P):
        np.savez(f"{prefix}.matrix.rank.{p}.npz",
                 magic=MAGIC, version=VERSION, fmt="global-shard",
                 **{k: v[p] for k, v in mat.items()})
        np.savez(f"{prefix}.pm.rank.{p}.npz",
                 magic=MAGIC, version=VERSION, fmt="pm-shard",
                 **{k: v[p] for k, v in pm.items()})


def read_global_csr(prefix: str):
    """Reconstruct a GlobalCSR written by `write_global_csr` (reference:
    ParallelManager::ReadFileASCII + per-rank matrix/ghost reads,
    docs/api-reference/multinode.rst:126-155)."""
    import json

    from ..parallel.partition import GlobalCSR

    with open(f"{prefix}.pm.json") as f:
        meta = json.load(f)
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{prefix}.pm.json: not a rocalution_tpu PM file")
    P = int(meta["nparts"])
    shards_m, shards_pm = [], []
    for p in range(P):
        zm = np.load(f"{prefix}.matrix.rank.{p}.npz", allow_pickle=False)
        if str(zm["fmt"]) != "global-shard":
            raise ValueError(f"{prefix}.matrix.rank.{p}: bad shard file")
        shards_m.append(zm)
        zp = np.load(f"{prefix}.pm.rank.{p}.npz", allow_pickle=False)
        if str(zp["fmt"]) != "pm-shard":
            raise ValueError(f"{prefix}.pm.rank.{p}: bad pm shard file")
        shards_pm.append(zp)

    import jax.numpy as jnp

    def stack(shards, key):
        return jnp.asarray(np.stack([z[key] for z in shards]))

    return GlobalCSR(
        **{k: stack(shards_m, k) for k in _GLOBAL_MAT_FIELDS},
        **{k: stack(shards_pm, k) for k in _GLOBAL_PM_FIELDS},
        nparts=P,
        n_local=int(meta["n_local"]),
        n_global=int(meta["n_global"]),
        shape=tuple(meta["shape"]),
        n_local_col=int(meta["n_local_col"]),
        n_global_col=int(meta["n_global_col"]),
        shifts=tuple(meta["shifts"]),
        mode=str(meta["mode"]),
        int_nnz=tuple(meta.get("int_nnz", ())),
    )
