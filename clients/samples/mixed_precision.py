"""Mixed-precision defect correction sample (reference:
clients/samples/mixed-precision.cpp): f64 outer DC around an f32 inner CG —
the inner solve streams 8 bytes per nonzero instead of 12."""

import os
import sys

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))

import numpy as np

import rocalution_tpu as rt

A = rt.laplacian_2d(64)
b = np.asarray(rt.spmv(A, np.ones(A.shape[0])))

x, info = rt.mixed_precision_dc(A, b, rel_tol=1e-10, max_iter=50)
print(f"MPDC: outer_iters={int(info.iterations)} "
      f"final_res={float(info.final_res):.3e} dtype={np.asarray(x).dtype}")
print("error:", np.linalg.norm(np.asarray(x) - 1.0))
