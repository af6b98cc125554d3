"""Distributed (multi-chip / multi-host) operation over a jax Mesh.

Replaces the reference's GlobalMatrix/GlobalVector/ParallelManager/MPI stack
(SURVEY.md §2.7) with row-partitioned shards + XLA collectives under
`shard_map`.
"""

from .ops import shard_operator, shard_spmv
from .partition import (GlobalCSR, distribute_csr, distribute_vector,
                        gather_vector, global_csr_from_blocks)
from .precond import ShardPrecond, block_jacobi_precond
from .solve import block_jacobi_diag, dist_solve, make_mesh

__all__ = [
    "GlobalCSR", "distribute_csr", "distribute_vector", "gather_vector",
    "global_csr_from_blocks", "shard_spmv", "shard_operator", "dist_solve",
    "make_mesh", "block_jacobi_diag", "block_jacobi_precond",
    "ShardPrecond", "DistLevels", "distributed_amg_setup",
    "dist_amg_solve_sharded", "dist_levels_from_blocks",
    "global_transpose", "global_triple_product",
]
from .amg import DistMG, dist_amg_solve, distribute_hierarchy
from .amg_setup import (DistLevels, dist_amg_solve_sharded,
                        dist_levels_from_blocks, distributed_amg_setup)
from .matops import global_transpose, global_triple_product
