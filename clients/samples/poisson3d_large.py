"""Large-scale SA-AMG preconditioned CG on the 3D Poisson problem.

The BASELINE north-star scale demo (3D Poisson up to 256^3): builds the
smoothed-aggregation hierarchy on the host (SpGEMM Galerkin — documented
setup-phase placement, ops/spgemm.py), converts it to an f32 device
hierarchy (DIA for banded levels, CSR for the others), and runs the whole
preconditioned-CG solve as ONE XLA program via `hoisted_jit` (operator
arrays ride as device-buffer arguments, never HLO constants).

POISSON_N=128 python clients/samples/poisson3d_large.py   # 2.1M unknowns

`chip_smoke.py` runs this deployment (f64, rel_tol 1e-10) on the card.
The distributed route (`poisson3d_dist.py`) is the scaling answer across
cards.
"""

import os
import sys
import time

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import numpy as np

import jax
import jax.numpy as jnp
import rocalution_tpu as rt
from rocalution_tpu.solvers.multigrid import (amg_hierarchy,
                                              convert_hierarchy,
                                              cycle_closure)
from rocalution_tpu.utils import hoisted_jit

n = int(os.environ.get("POISSON_N", "64"))
A = rt.laplacian_3d(n, dtype=np.float64)
N = A.shape[0]
print(f"3D Poisson {n}^3: N={N} nnz={A.nnz}")

t0 = time.perf_counter()
hier = amg_hierarchy(A, "sa", coarse_size=1000)
t_setup = time.perf_counter() - t0
print(f"setup: {t_setup:.1f}s levels={hier.operator_sizes()}")

hier = convert_hierarchy(hier, dtype=np.float32)
M = cycle_closure(hier)
# b = A @ 1 computed host-side (the fine f64 operator never leaves host)
d, i, p = A.numpy_triplet()
# row sums via bincount over row ids (reduceat mis-handles empty rows:
# it returns d[p[i]] instead of 0 when p[i] == p[i+1])
row_ids = np.repeat(np.arange(A.shape[0]), np.diff(p))
b = np.bincount(row_ids, weights=d, minlength=A.shape[0]).astype(np.float32)
A0 = hier.levels[0].A


def raw(b):
    xs, info = rt.cg(A0, b, M=M, rel_tol=1e-6, max_iter=200)
    return xs, info.iterations, info.final_res


solve = hoisted_jit(raw, b)
xs, it, res = solve(jax.device_put(b))
float(jnp.sum(xs))                       # compile + first solve
t0 = time.perf_counter()
xs, it, res = solve(jax.device_put(b))
float(jnp.sum(xs))
t_solve = time.perf_counter() - t0
err = float(np.linalg.norm(np.asarray(xs) - 1.0)) / np.sqrt(N)
print(f"cg+saamg {n}^3: iters={int(it)} res={float(res):.2e} "
      f"rms_err={err:.2e} solve={t_solve*1e3:.0f} ms setup={t_setup:.1f}s")
assert err < 1e-4
