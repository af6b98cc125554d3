"""Row-wise domain decomposition (ParallelManager analog).

Reference parity: `ParallelManager` (src/base/parallel_manager.hpp:50-298) and
the canonical `distribute_matrix` recipe (clients/include/common.hpp:56-300):
non-overlapping block-row partition; each rank holds an *interior* matrix
(columns it owns, renumbered locally) and a *ghost* matrix (columns owned by
others, renumbered into a ghost buffer), plus boundary send lists and
ghost→owner receive maps.

Design: all parts live in ONE program as stacked (P, ...) arrays
consumed by `shard_map` over a device mesh; part p's slice sits on the
mesh's p-th device from construction on (`shard_stacked`). Shapes are
padded to per-part maxima so every shard is identical — static shapes are
what XLA wants. The
MPI Isend/Irecv neighbor plumbing (parallel_manager.cpp:726-782) becomes a
static gather → `all_gather` of fixed-size boundary buffers → static take;
deterministic by construction (matches the reference's fixed communication
order guarantee).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..formats import CSR, to_csr
from ..formats.base import register_format, static_field

AXIS = "p"


def make_mesh(nparts: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()[:nparts]
    if len(devices) < nparts:
        raise ValueError(
            f"need {nparts} devices for {nparts} parts, have {len(devices)}"
        )
    return Mesh(np.asarray(devices).reshape(nparts), (AXIS,))


def shard_stacked(tree, mesh: Optional[Mesh] = None):
    """Place every (P, ...) leaf of `tree` so that part p sits on the p-th
    device of `mesh` (default: `make_mesh(P)`). Leaves already placed so
    are not copied. Without a mesh and with fewer devices than parts (host
    bookkeeping of more parts than the process sees) the leaves go to the
    default device; a solve over them needs a mesh of P devices, and the
    solve entry points place them on it."""
    if mesh is None:
        nparts = jax.tree.leaves(tree)[0].shape[0]
        if jax.device_count() < nparts:
            return jax.tree.map(jnp.asarray, tree)
        mesh = make_mesh(nparts)
    return jax.device_put(tree, NamedSharding(mesh, PartitionSpec(AXIS)))


@register_format
@dataclasses.dataclass(frozen=True)
class GlobalCSR:
    """Distributed CSR operator: stacked per-part interior + ghost shards.

    Analog of GlobalMatrix = interior LocalMatrix + ghost LocalMatrix + PM
    (src/base/global_matrix.hpp:57).
    """

    int_data: jnp.ndarray    # (P, nnz_int)
    int_cols: jnp.ndarray    # (P, nnz_int) local column ids
    int_rows: jnp.ndarray    # (P, nnz_int) local row ids (sorted)
    ghost_data: jnp.ndarray  # (P, nnz_gst)
    ghost_cols: jnp.ndarray  # (P, nnz_gst) indices into the ghost buffer
    ghost_rows: jnp.ndarray  # (P, nnz_gst) local row ids (sorted)
    send_idx: jnp.ndarray    # (P, max_send) local rows gathered into send buffer
    recv_idx: jnp.ndarray    # (P, max_ghost) flat recv-buffer indices
    send_off: jnp.ndarray    # (P, D, W) per-shift send lists (neighbor mode)
    nparts: int = static_field(default=1)
    n_local: int = static_field(default=0)      # rows per part
    n_global: int = static_field(default=0)    # true (unpadded) row count
    shape: Tuple[int, int] = static_field(default=(0, 0))
    # rectangular operators (distributed AMG transfers): column partition
    n_local_col: int = static_field(default=0)  # cols per part (0 = square)
    n_global_col: int = static_field(default=0)
    # neighbor-sparse exchange metadata: static shifts s (receiver = sender+s)
    # and the exchange mode — "ppermute" (one collective per neighbor shift,
    # volume O(sum of boundaries) — the reference's neighbor-sparse property,
    # parallel_manager.cpp:726-782) or "allgather" (fallback when the
    # partition couples many parts)
    shifts: Tuple[int, ...] = static_field(default=())
    mode: str = static_field(default="allgather")
    # per-part valid interior-entry counts (entries beyond are padding):
    # lets consumers recover each block's exact sparsity pattern including
    # genuinely stored zeros (advisor r3: a data != 0 mask silently drops
    # them). () = unknown, fall back to the data mask.
    int_nnz: Tuple[int, ...] = static_field(default=())

    @property
    def dtype(self):
        return self.int_data.dtype

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.int_data))) + int(
            np.count_nonzero(np.asarray(self.ghost_data))
        )


def _pad1(a, length, fill=0):
    a = np.asarray(a)
    out = np.full((length,), fill, dtype=a.dtype if a.size else np.int64)
    out[: len(a)] = a
    return out


def distribute_csr(A, nparts: int, max_neighbor_shifts: int = 6) -> GlobalCSR:
    """Partition a host CSR into a GlobalCSR over `nparts` shards.

    Mirrors the boundary/ghost classification of clients/include/common.hpp:
    rows are split into equal blocks (square matrices are padded with unit
    diagonal rows to a multiple of nparts — padding rows are inert: x=0
    stays 0). Rectangular operators (AMG transfer P/R) are supported: rows
    follow the row partition, columns the column partition; padding rows
    are simply empty.
    """
    csr = to_csr(A)
    data, cols, indptr = csr.numpy_triplet()
    n, ncol = csr.shape
    P = int(nparts)
    nl = -(-n // P)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    blocks = []
    for p in range(P):
        m = (rows >= p * nl) & (rows < (p + 1) * nl)
        blocks.append((rows[m] - p * nl, cols[m], data[m]))
    return global_csr_from_blocks(
        blocks, (n, ncol), max_neighbor_shifts=max_neighbor_shifts)


def global_csr_from_blocks(blocks, shape,
                           max_neighbor_shifts: int = 6) -> GlobalCSR:
    """Assemble a GlobalCSR from per-part row blocks — the ParallelManager
    construction core (reference: distribute_matrix, common.hpp:56-300, and
    PM derivation for coarse operators, parallel_manager.hpp:204-212).

    `blocks[p]` = (local_rows, global_cols, values) for the rows
    [p*nl, (p+1)*nl) this part owns (nl = ceil(nrow/P)). Used directly by
    the distributed AMG setup so no level is ever materialized as one
    global matrix."""
    P = len(blocks)
    n, ncol = int(shape[0]), int(shape[1])
    square = n == ncol
    nl = -(-n // P)
    ncl = nl if square else -(-ncol // P)
    n_pad = nl * P
    dtype = next(
        (np.asarray(b[2]).dtype for b in blocks if len(b[2])), np.float64)
    part_r = [np.asarray(b[0], dtype=np.int64) for b in blocks]
    part_c = [np.asarray(b[1], dtype=np.int64) for b in blocks]
    part_d = [np.asarray(b[2]) for b in blocks]

    # host block cache (true rows, BEFORE inert padding): the operand for
    # the standalone distributed setup ops (parallel/matops.py —
    # GlobalMatrix::Transpose / TripleMatrixProduct analogs)
    import scipy.sparse as sp

    cache_offs = np.minimum(np.arange(P + 1, dtype=np.int64) * nl, n)
    cache_mats = [
        sp.csr_matrix(
            (part_d[p], (part_r[p], part_c[p])),
            shape=(int(cache_offs[p + 1] - cache_offs[p]), ncol))
        for p in range(P)
    ]

    if square and n_pad > n:
        # pad the tail part with inert unit-diagonal rows
        p = P - 1
        extra = np.arange(n, n_pad, dtype=np.int64)
        part_r[p] = np.concatenate([part_r[p], extra - p * nl])
        part_c[p] = np.concatenate([part_c[p], extra])
        part_d[p] = np.concatenate(
            [part_d[p], np.ones(n_pad - n, dtype=dtype)])
    for p in range(P):       # row-major order (sorted segment_sum wants it)
        order = np.lexsort((part_c[p], part_r[p]))
        part_r[p], part_c[p], part_d[p] = (
            part_r[p][order], part_c[p][order], part_d[p][order])

    # ghost columns needed per part
    ghost_cols_of = []
    for p in range(P):
        owner_p = part_c[p] // ncl
        ghost_cols_of.append(np.unique(part_c[p][owner_p != p]))

    # boundary (send) rows per part: union of other parts' ghost needs
    send_of = []
    for p in range(P):
        lo, hi = p * ncl, (p + 1) * ncl
        need = np.unique(
            np.concatenate(
                [g[(g >= lo) & (g < hi)] for q, g in enumerate(ghost_cols_of) if q != p]
                or [np.array([], dtype=np.int64)]
            )
        )
        send_of.append(need - lo)  # local indices

    max_send = max(1, max(len(s) for s in send_of))
    max_ghost = max(1, max(len(g) for g in ghost_cols_of))

    # neighbor shifts: receiver p needs owner o -> sender o ships with
    # shift s = p - o (receiver = sender + s)
    shift_set = sorted({
        int(s)
        for p in range(P)
        for s in np.unique(p - ghost_cols_of[p] // ncl)
    })
    use_pp = 0 < len(shift_set) <= max_neighbor_shifts
    shifts = tuple(shift_set) if use_pp else ()

    if use_pp:
        sidx = {s: i for i, s in enumerate(shift_set)}
        # per (sender, shift) sorted send lists (local indices)
        send_lists = [[np.array([], np.int64) for _ in shift_set]
                      for _ in range(P)]
        for p in range(P):
            g = ghost_cols_of[p]
            o = g // ncl
            for s in np.unique(p - o):
                sel = (p - o) == s
                sender = p - s
                send_lists[sender][sidx[int(s)]] = np.sort(
                    g[sel] - sender * ncl
                )
        W = max(1, max(len(l) for ls in send_lists for l in ls))
        send_off_np = np.zeros((P, len(shift_set), W), np.int64)
        for q in range(P):
            for i, l in enumerate(send_lists[q]):
                send_off_np[q, i, : len(l)] = l
        # receive map into the concatenated (D*W,) per-shift recv buffers.
        # Vectorized per shift group (was a per-ghost Python loop — O(boundary)
        # interpreter work that bit at 256³): a (sender, shift) send list is
        # exactly THIS receiver's sorted ghost block for that owner, so the
        # position of each ghost in it is its rank — a plain arange.
        recv_of = []
        for p in range(P):
            g = ghost_cols_of[p]
            o = g // ncl
            flat = np.empty(len(g), dtype=np.int64)
            for s in np.unique(p - o):
                sel = (p - o) == s
                flat[sel] = sidx[int(s)] * W + np.arange(int(sel.sum()))
            recv_of.append(flat)
    else:
        send_off_np = np.zeros((P, 1, 1), np.int64)
        # all_gather mode: ghost col g of part p lives at owner o = g // ncl,
        # at the position of g in send_of[o]; flat index o*max_send + pos
        # (vectorized per owner group: send_of[o] is the UNION of all
        # receivers' needs, so the rank comes from one searchsorted)
        recv_of = []
        for p in range(P):
            g = ghost_cols_of[p]
            o = g // ncl
            flat = np.empty(len(g), dtype=np.int64)
            for ov in np.unique(o):
                sel = o == ov
                flat[sel] = ov * max_send + np.searchsorted(
                    send_of[ov], g[sel] - ov * ncl)
            recv_of.append(flat)

    # split nnz per part into interior / ghost, renumber, pad
    int_d, int_c, int_r, gst_d, gst_c, gst_r = [], [], [], [], [], []
    for p in range(P):
        rp, cp, dp = part_r[p], part_c[p], part_d[p]
        imask = (cp // ncl) == p
        int_d.append(dp[imask])
        int_c.append(cp[imask] - p * ncl)
        int_r.append(rp[imask])
        gmask = ~imask
        gcols = np.searchsorted(ghost_cols_of[p], cp[gmask])
        gst_d.append(dp[gmask])
        gst_c.append(gcols)
        gst_r.append(rp[gmask])

    nnz_int = max(1, max(len(d) for d in int_d))
    nnz_gst = max(1, max(len(d) for d in gst_d))

    def stack(parts, length, fill, dt):
        return np.stack([_pad1(x, length, fill) for x in parts]).astype(dt)

    arrays = shard_stacked(dict(
        int_data=stack(int_d, nnz_int, 0, dtype),
        int_cols=stack(int_c, nnz_int, 0, np.int32),
        int_rows=stack(int_r, nnz_int, nl - 1, np.int32),
        ghost_data=stack(gst_d, nnz_gst, 0, dtype),
        ghost_cols=stack(gst_c, nnz_gst, 0, np.int32),
        ghost_rows=stack(gst_r, nnz_gst, nl - 1, np.int32),
        send_idx=stack(send_of, max_send, 0, np.int32),
        recv_idx=stack(recv_of, max_ghost, 0, np.int32),
        send_off=send_off_np.astype(np.int32),
    ))
    out = GlobalCSR(
        **arrays,
        nparts=P,
        n_local=nl,
        n_global=n,
        shape=(n, ncol),
        shifts=shifts,
        mode="ppermute" if use_pp else "allgather",
        n_local_col=ncl,
        n_global_col=ncol,
        int_nnz=tuple(len(d) for d in int_d),
    )
    object.__setattr__(out, "_block_cache", (cache_mats, cache_offs))
    return out


def distribute_vector(v, nparts: int, n_local: int) -> jnp.ndarray:
    """Pad and reshape a global vector to stacked per-part shards (P, n_local),
    placed by `shard_stacked`."""
    v = np.asarray(v)
    n_pad = nparts * n_local
    out = np.zeros((n_pad,) + v.shape[1:], dtype=v.dtype)
    out[: len(v)] = v
    return shard_stacked(out.reshape((nparts, n_local) + v.shape[1:]))


def gather_vector(vp, n_global: int) -> jnp.ndarray:
    """Stacked shards (P, n_local) -> global vector (n_global,)."""
    flat = jnp.reshape(vp, (-1,) + vp.shape[2:])
    return flat[:n_global]
