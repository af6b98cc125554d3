"""Distributed solver driver.

Reference parity: the Global instantiation of every solver
(e.g. cg.cpp:459-466) — one code path serves Local and Global operators.
Here: the same functional solver (rocalution_tpu.solvers.*) is closed over a
per-shard operator and run inside `shard_map` across a 1-D device mesh; the
IterationControl state is replicated across shards because every scalar it
consumes is a `psum` result.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..solvers.iter_ctrl import SolverInfo
from .ops import shard_operator
from .partition import (AXIS, GlobalCSR, distribute_vector, gather_vector,
                        make_mesh, shard_stacked)


def dist_solve(
    solver: Callable,
    A: GlobalCSR,
    b,
    x0=None,
    M=None,
    mesh: Optional[Mesh] = None,
    **kwargs,
):
    """Run a functional solver distributed over a device mesh.

    `solver` is any rocalution_tpu solver taking (A, b, x0, M, **kwargs) and
    honoring `axis_name` (cg, bicgstab, gmres, ...). `M` may be a stacked
    per-shard diagonal (P, n_local) — the BlockJacobi/Jacobi global
    preconditioner — or a `parallel.precond.ShardPrecond` (BlockJacobi with
    a LOCAL sub-preconditioner per diagonal block: SPAI/FSAI/ILU/ILUT, the
    reference's preconditioner_blockjacobi.hpp as used by every
    preconditioned MPI sample) — or None.
    """
    from .precond import ShardPrecond

    P_ = A.nparts
    if mesh is None:
        mesh = make_mesh(P_)
    bp = b if (hasattr(b, "ndim") and b.ndim == 2) else distribute_vector(
        np.asarray(b), P_, A.n_local
    )
    x0p = (
        None
        if x0 is None
        else (x0 if (hasattr(x0, "ndim") and x0.ndim == 2)
              else distribute_vector(np.asarray(x0), P_, A.n_local))
    )

    has_x0 = x0p is not None
    is_sp = isinstance(M, ShardPrecond)
    has_m = M is not None

    def shard_fn(A, b_l, x0_l, m_l):
        op = shard_operator(A, AXIS)
        precond = None
        if is_sp:
            arrs = jax.tree.map(lambda v: v[0], m_l)
            precond = lambda r: M.shard_apply(arrs, r)
        elif has_m:
            inv = m_l[0]
            precond = lambda r: inv * r
        x_init = x0_l[0] if has_x0 else None
        x, info = solver(
            op, b_l[0], x_init, precond, axis_name=AXIS, **kwargs
        )
        return x[None], jax.tree.map(lambda v: jnp.asarray(v)[None], info)

    zeros = np.zeros((P_, A.n_local), bp.dtype)
    m_arg = M.arrays if is_sp else (M if has_m else zeros)
    # every (P, ...) operand on its own device of the mesh, whichever
    # device the caller built it on
    A, bp, x0p, m_arg = shard_stacked(
        (A, bp, x0p if has_x0 else zeros, m_arg), mesh)
    in_specs = (
        jax.tree.map(lambda _: P(AXIS), A),
        P(AXIS), P(AXIS), jax.tree.map(lambda _: P(AXIS), m_arg),
    )
    out_specs = (P(AXIS), jax.tree.map(lambda _: P(AXIS), _info_struct()))

    # one compiled program (an eager shard_map dispatches and compiles
    # operation by operation)
    fn = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    ))
    xp, info_stacked = fn(A, bp, x0p, m_arg)
    info = jax.tree.map(lambda v: v[0], info_stacked)
    return gather_vector(xp, A.n_global), info


def _info_struct():
    z = 0
    return SolverInfo(z, z, z, z, z)


def block_jacobi_diag(A: GlobalCSR) -> jnp.ndarray:
    """Stacked inverse diagonal (P, n_local) for BlockJacobi/Jacobi
    preconditioning of a GlobalCSR (reference: the Global Jacobi,
    preconditioner.cpp:1121-1127)."""
    is_diag = np.asarray(A.int_rows) == np.asarray(A.int_cols)
    data = np.asarray(A.int_data)
    P_, nl = data.shape[0], A.n_local
    diag = np.zeros((P_, nl), dtype=data.dtype)
    rows = np.asarray(A.int_rows)
    for p in range(P_):
        np.add.at(diag[p], rows[p][is_diag[p]], data[p][is_diag[p]])
    inv = np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag), 1.0)
    return shard_stacked(inv)
