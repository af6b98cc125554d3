"""rocalution_tpu — a sparse linear-algebra and iterative-solver framework
with the capability surface of ROCm/rocALUTION, rebuilt from scratch on
JAX/XLA; its accelerator is an NVIDIA GPU (H100).

Architecture (vs. reference, see SURVEY.md):
* formats/  — matrix format pytrees (CSR/COO/ELL/DIA/HYB/BCSR/MCSR/DENSE)
* ops/      — BLAS-1, SpMV/SpMM, SpGEMM, tri-solves, factorizations, orderings
* solvers/  — on-device Krylov/fixed-point/Chebyshev/multigrid solvers
* precond/  — the preconditioner stack
* parallel/ — row-partitioned distributed operators over a jax Mesh
* io/       — MatrixMarket and binary readers/writers
* utils/    — generators, timing, validation
"""

from . import backend
from .backend import info, init, stop, sync
from .config import (get_config, set_debug, set_default_dtype, set_verbose)
from . import io, ops, precond, solvers, utils
from .formats import (BCSR, COO, CSR, DENSE, DIA, ELL, HYB, MCSR,
                      Stencil, convert, laplace2d_stencil, laplace3d_stencil,
                      to_csr)
from .ops import blas1
from .ops.spectral import gershgorin, power_method
from .ops.spmv import spmv, spmv_add
from .precond.jacobi import jacobi
from .solvers import (IterationControl, SolverInfo, bicgstab, bicgstabl, cg,
                      chebyshev, cr, fcg, fgmres, fixed_point,
                      fixed_point_sweeps, gmres, idr, mixed_precision_dc,
                      qmrcgstab)
from .utils.generators import (anisotropic_laplacian_2d,
                               convection_diffusion_2d, fem_2d_unstructured,
                               laplacian_2d,
                               laplacian_3d, random_banded_spd)

__version__ = "0.1.0"
