"""Distributed benchmark sample (reference:
clients/samples/benchmark_mpi.cpp): sharded halo-exchange SpMV and global
reductions over the mesh, per-op timing with the reference byte models.

Run on CPU mesh: JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8 python ...
"""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import time

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import rocalution_tpu as rt
from rocalution_tpu.parallel import distribute_csr, make_mesh
from rocalution_tpu.parallel.ops import shard_spmv
from rocalution_tpu.parallel.solve import AXIS

nparts = min(8, len(jax.devices()))
A = rt.laplacian_3d(32)
Ag = distribute_csr(A, nparts)
mesh = make_mesh(nparts)
xg = rt.parallel.distribute_vector(
    np.random.default_rng(0).standard_normal(A.shape[0]) / A.shape[0],
    nparts, Ag.n_local)


def shard_step(Ag, x):
    y = shard_spmv(Ag, x[0], AXIS)
    # global dot: the once-per-Krylov-iteration psum reduction
    s = jax.lax.psum(jnp.vdot(y, y), AXIS)
    return (y / jnp.sqrt(s))[None]


fn = jax.shard_map(shard_step, mesh=mesh,
                   in_specs=(jax.tree.map(lambda _: P(AXIS), Ag), P(AXIS)),
                   out_specs=P(AXIS), check_vma=False)


@jax.jit
def chain(Ag, x, k):
    return jnp.sum(jax.lax.fori_loop(
        0, k, lambda i, c: fn(Ag, c), x))


reps = 50
float(chain(Ag, xg, 2))
t0 = time.perf_counter(); float(chain(Ag, xg, reps))
t1 = time.perf_counter(); float(chain(Ag, xg, 2 * reps))
t2 = time.perf_counter()
dt = max(((t2 - t1) - (t1 - t0)) / reps, 1e-12)
vs = np.dtype(str(Ag.int_data.dtype)).itemsize
gbs = (vs + 4) * A.nnz / dt / 1e9
print(f"dist spmv+psum-norm over {nparts} parts (mode={Ag.mode}): "
      f"{dt*1e6:.1f} us/apply  {gbs:.2f} GB/s aggregate")
