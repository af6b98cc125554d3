"""Per-shard distributed operations under `shard_map`.

Reference parity: GlobalMatrix::Apply with overlapped halo exchange
(src/base/global_matrix.cpp:924-1009) and GlobalVector reductions
(global_vector.cpp:547-585). The JAX formulation: boundary values are
gathered by a static take, exchanged over the mesh axis with fixed-size
buffers (deterministic; XLA hands the collective to NCCL), and the
interior SpMV is issued before the ghost SpMV so XLA's latency-hiding
scheduler overlaps it with the collective — the role of the reference's
interior/ghost HIP streams.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .partition import GlobalCSR


class ShardView:
    """Per-shard (inside shard_map) view of a GlobalCSR: leading P axis
    squeezed away."""

    __slots__ = ("A",)

    def __init__(self, A: GlobalCSR):
        self.A = A

    def __getattr__(self, name):
        v = getattr(self.A, name)
        if isinstance(v, jnp.ndarray) and v.ndim >= 1:
            return v[0]
        return v


def shard_spmv(A: GlobalCSR, x_local: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """y_local = (A @ x)_local with halo exchange (call inside shard_map).

    Neighbor-sparse mode: one `ppermute` per static neighbor shift — comm
    volume is the true boundary size (the reference's Isend/Irecv-per-
    neighbor property, parallel_manager.cpp:726-782).
    Fallback (partitions coupling many parts): one `all_gather` of the
    fixed-size boundary buffer. Either way the collective is issued before
    the interior SpMV so XLA's latency-hiding scheduler overlaps them (the
    role of the reference's interior/ghost streams).
    """
    v = ShardView(A)
    nl = A.n_local
    P = A.nparts
    if A.mode == "ppermute" and A.shifts:
        recvs = []
        for di, s in enumerate(A.shifts):
            buf = x_local[v.send_off[di]]                   # (W,)
            perm = [(q, q + s) for q in range(P) if 0 <= q + s < P]
            recvs.append(jax.lax.ppermute(buf, axis_name, perm=perm))
        recv_flat = jnp.concatenate(recvs)                  # (D*W,)
    else:
        send = x_local[v.send_idx]
        all_send = jax.lax.all_gather(send, axis_name)      # (P, max_send)
        recv_flat = all_send.reshape(-1)
    # interior SpMV (overlaps with the collectives under XLA scheduling)
    y = jax.ops.segment_sum(
        v.int_data * x_local[v.int_cols], v.int_rows,
        num_segments=nl, indices_are_sorted=True,
    )
    # ghost SpMV on the received boundary values
    ghost_vals = recv_flat[v.recv_idx]                      # (max_ghost,)
    y = y + jax.ops.segment_sum(
        v.ghost_data * ghost_vals[v.ghost_cols], v.ghost_rows,
        num_segments=nl, indices_are_sorted=True,
    )
    return y


def shard_operator(A: GlobalCSR, axis_name: str):
    """Closure x_local -> (A @ x)_local for use by any solver."""
    return lambda x: shard_spmv(A, x, axis_name)
