"""True multi-process (SPMD) distributed execution.

Reference parity: the MPI flow — every rank constructs its OWN matrix
part and ParallelManager from local data plus point-to-point boundary
messages (src/base/parallel_manager.cpp:726-782; per-rank IO + PM setup,
docs/api-reference/multinode.rst:126-155), then all ranks run the same
solver SPMD.

JAX formulation: `jax.distributed.initialize` (via `backend.init`)
federates the processes; the only setup-phase exchange the GlobalCSR
layout needs is each part's GHOST COLUMN LIST (boundary-size metadata),
carried by `multihost_utils.process_allgather` — the analog of the
reference's neighbor-index communication. Everything else (send lists,
shifts, receive maps) is then derived locally and deterministically by
every process, and the per-part arrays are lifted into global jax Arrays
(`make_array_from_process_local_data`) consumed by the SAME `shard_map`
solve path the single-process driver uses. jit compiles one SPMD program
across all processes' devices; collectives (`psum`/`ppermute`) ride the
real interconnect.

Works on any backend jax.distributed supports — the 2-process CPU (gloo)
configuration is exercised by tests/test_multiproc.py. On GPUs, start one
process per card, each with its own ``CUDA_VISIBLE_DEVICES`` (a JAX
process reserves most of the memory of every card it sees), and pass
``coordinator_address``/``num_processes``/``process_id`` to `backend.init`
(see docs/guide.md "Multi-process execution").
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["allgather_host", "process_mesh", "global_csr_multiproc",
           "dist_solve_spmd"]


def allgather_host(arr: np.ndarray):
    """All-gather a variable-length 1-D HOST array across processes.

    Two fixed-shape collectives (lengths, then padded payload) — the
    pattern of the reference's size-prefixed boundary-index messages
    (parallel_manager.cpp:726-782). Returns a list of np arrays, one per
    process."""
    from jax.experimental import multihost_utils

    arr = np.asarray(arr)
    lens = np.asarray(multihost_utils.process_allgather(
        np.asarray([arr.shape[0]], np.int64))).reshape(-1)
    L = max(1, int(lens.max()))
    pad = np.zeros(L, arr.dtype if arr.size else np.int64)
    pad[: arr.shape[0]] = arr
    out = np.asarray(multihost_utils.process_allgather(pad))
    return [out[p, : int(lens[p])] for p in range(out.shape[0])]


def process_mesh(axis: str = "p"):
    """1-D mesh with exactly ONE device per process (the MPI-rank analog)
    — robust to environments that expose several local devices per host
    (e.g. xla_force_host_platform_device_count)."""
    from jax.sharding import Mesh

    per_proc = {}
    for dev in sorted(jax.devices(), key=lambda d: d.id):
        per_proc.setdefault(dev.process_index, dev)
    devs = np.asarray([per_proc[i] for i in sorted(per_proc)])
    return Mesh(devs.reshape(len(devs)), (axis,))


def global_csr_multiproc(block, shape, *, mesh=None,
                         max_neighbor_shifts: int = 6):
    """Build a GlobalCSR when THIS process owns only its own row block.

    `block` = (local_rows, global_cols, values) for rows
    [pid*nl, (pid+1)*nl) of the global operator (nl = ceil(n/P)) — the
    same per-part block format as `global_csr_from_blocks`, but no
    process ever sees another part's values: only the ghost-column
    metadata is exchanged (boundary-size, via `allgather_host`), and the
    stacked (P, ...) operator arrays are GLOBAL jax Arrays whose p-th
    shard lives on process p.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .partition import GlobalCSR, _pad1

    if mesh is None:
        mesh = process_mesh()
    axis = mesh.axis_names[0]
    pid = jax.process_index()
    Pn = jax.process_count()
    n, ncol = int(shape[0]), int(shape[1])
    square = n == ncol
    nl = -(-n // Pn)
    ncl = nl if square else -(-ncol // Pn)
    n_pad = nl * Pn

    r = np.asarray(block[0], np.int64)
    c = np.asarray(block[1], np.int64)
    d = np.asarray(block[2])
    if square and n_pad > n and pid == Pn - 1:
        extra = np.arange(n, n_pad, dtype=np.int64)
        r = np.concatenate([r, extra - pid * nl])
        c = np.concatenate([c, extra])
        d = np.concatenate([d, np.ones(n_pad - n, d.dtype)])
    order = np.lexsort((c, r))
    r, c, d = r[order], c[order], d[order]

    # ghost metadata exchange — the ONLY cross-process setup traffic
    owner = c // ncl
    my_ghost = np.unique(c[owner != pid])
    ghost_cols_of = allgather_host(my_ghost)

    # send rows: union of other parts' ghost needs inside my column range
    lo, hi = pid * ncl, (pid + 1) * ncl
    need = np.unique(np.concatenate(
        [g[(g >= lo) & (g < hi)] for q, g in enumerate(ghost_cols_of)
         if q != pid] or [np.array([], np.int64)]))
    send_own = need - lo
    send_lens = allgather_host(np.asarray([len(send_own)], np.int64))
    max_send = max(1, int(max(int(v[0]) for v in send_lens)))
    max_ghost = max(1, max(len(g) for g in ghost_cols_of))

    # neighbor shifts (deterministic from the gathered metadata)
    shift_set = sorted({
        int(s) for p in range(Pn)
        for s in np.unique(p - ghost_cols_of[p] // ncl)})
    use_pp = 0 < len(shift_set) <= max_neighbor_shifts
    shifts = tuple(shift_set) if use_pp else ()

    if use_pp:
        sidx = {s: i for i, s in enumerate(shift_set)}
        # (sender q, shift s) serves receiver p = q + s with p's sorted
        # ghost block for owner q — derivable from the gathered lists
        my_lists = [np.array([], np.int64) for _ in shift_set]
        W = 1
        for p in range(Pn):
            g = ghost_cols_of[p]
            o = g // ncl
            for s in np.unique(p - o):
                sel = (p - o) == s
                W = max(W, int(sel.sum()))
                if p - s == pid:
                    my_lists[sidx[int(s)]] = np.sort(
                        g[sel] - pid * ncl)
        send_off_own = np.zeros((1, len(shift_set), W), np.int64)
        for i, l in enumerate(my_lists):
            send_off_own[0, i, : len(l)] = l
        g = ghost_cols_of[pid]
        o = g // ncl
        recv_own = np.empty(len(g), np.int64)
        for s in np.unique(pid - o):
            sel = (pid - o) == s
            recv_own[sel] = sidx[int(s)] * W + np.arange(int(sel.sum()))
    else:
        send_off_own = np.zeros((1, 1, 1), np.int64)
        g = ghost_cols_of[pid]
        o = g // ncl
        recv_own = np.empty(len(g), np.int64)
        # positions come from the OWNER's send list — exchange those too
        send_lists_all = allgather_host(send_own)
        for ov in np.unique(o):
            sel = o == ov
            recv_own[sel] = ov * max_send + np.searchsorted(
                send_lists_all[ov], g[sel] - ov * ncl)

    # interior / ghost split of OWN rows
    imask = (c // ncl) == pid
    gmask = ~imask
    gcols = np.searchsorted(ghost_cols_of[pid], c[gmask])
    nnz_i_own = int(imask.sum())
    nnz_g_own = int(gmask.sum())
    nnz_int = max(1, int(max(int(v[0]) for v in allgather_host(
        np.asarray([nnz_i_own], np.int64)))))
    nnz_gst = max(1, int(max(int(v[0]) for v in allgather_host(
        np.asarray([nnz_g_own], np.int64)))))

    def lift(local_1xd, spec_tail):
        sh = NamedSharding(mesh, P(axis, *spec_tail))
        return jax.make_array_from_process_local_data(
            sh, local_1xd)

    def lift1(a, length, fill, dt):
        return lift(_pad1(a, length, fill).astype(dt)[None], (None,))

    out = GlobalCSR(
        int_data=lift1(d[imask], nnz_int, 0, d.dtype),
        int_cols=lift1(c[imask] - pid * ncl, nnz_int, 0, np.int32),
        int_rows=lift1(r[imask], nnz_int, nl - 1, np.int32),
        ghost_data=lift1(d[gmask], nnz_gst, 0, d.dtype),
        ghost_cols=lift1(gcols, nnz_gst, 0, np.int32),
        ghost_rows=lift1(r[gmask], nnz_gst, nl - 1, np.int32),
        send_idx=lift1(send_own, max_send, 0, np.int32),
        recv_idx=lift1(recv_own, max_ghost, 0, np.int32),
        send_off=lift(send_off_own.astype(np.int32), (None, None)),
        nparts=Pn,
        n_local=nl,
        n_global=n,
        shape=(n, ncol),
        n_local_col=0 if square else ncl,
        n_global_col=0 if square else ncol,
        shifts=shifts,
        mode="ppermute" if use_pp else "allgather",
        int_nnz=(),
    )
    return out


def dist_solve_spmd(solver: Callable, A, b_local, *, mesh=None,
                    inv_diag_local: Optional[np.ndarray] = None,
                    x_true_local: Optional[np.ndarray] = None,
                    **kwargs):
    """Run a solver SPMD across processes on a multiproc GlobalCSR.

    `b_local` (and the optional Jacobi `inv_diag_local` / reference
    `x_true_local`): THIS process's (n_local,) slice. Returns
    (x_own_shard, info, err) where `err` is the GLOBAL ||x - x_true||_2
    (psum-reduced inside the solve; NaN when x_true_local is None) — no
    cross-process gather of the solution is ever needed.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .ops import shard_operator
    from .solve import AXIS, _info_struct

    if mesh is None:
        mesh = process_mesh(AXIS)

    def lift(v):
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(AXIS, None)), np.asarray(v)[None])

    bp = lift(b_local)
    nloc = len(np.asarray(b_local))
    mp = lift(inv_diag_local if inv_diag_local is not None
              else np.ones(nloc, np.asarray(b_local).dtype))
    xt = lift(x_true_local if x_true_local is not None
              else np.full(nloc, np.nan, np.asarray(b_local).dtype))

    def shard_fn(A, b_l, m_l, xt_l):
        op = shard_operator(A, AXIS)
        M = (lambda r: m_l[0] * r) if inv_diag_local is not None else None
        x, info = solver(op, b_l[0], None, M, axis_name=AXIS, **kwargs)
        err2 = jax.lax.psum(jnp.sum((x - xt_l[0]) ** 2), AXIS)
        return (x[None], jax.tree.map(lambda v: jnp.asarray(v)[None], info),
                jnp.sqrt(err2))

    in_specs = (jax.tree.map(lambda _: P(AXIS), A), P(AXIS), P(AXIS),
                P(AXIS))
    out_specs = (P(AXIS), jax.tree.map(lambda _: P(AXIS), _info_struct()),
                 P())
    fn = jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False))
    xp, info_stacked, err = fn(A, bp, mp, xt)
    # every process reads ITS OWN addressable shards (info scalars are
    # psum-replicated, identical on every shard)
    info = jax.tree.map(
        lambda v: np.asarray(v.addressable_shards[0].data)[0], info_stacked)
    x_own = np.asarray(xp.addressable_shards[0].data)[0]
    return x_own, info, float(err)
