"""Mixed-precision defect correction.

Reference parity: MixedPrecisionDC (src/solvers/mixed_precision.{hpp,cpp}) —
outer high-precision defect-correction loop around an inner low-precision
solver: r_h = b - A x (fp64); r_l = cast(r_h); solve A_l d_l = r_l; x += cast
(d_l); repeat (SolveNonPrecond_ loop, mixed_precision.cpp:369-399).

Why it pays: Krylov solves are memory-bound, and an f32 CSR operator moves
8 bytes per nonzero against 12 in f64 — the inner solve streams fewer bytes
while the outer loop restores f64 accuracy. The outer loop runs as a host-side Python loop (one
jitted inner solve per sweep), matching the reference's structure where the
two precisions are distinct object hierarchies.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.spmv import as_operator
from .iter_ctrl import IterationControl, SolverInfo
from .krylov.cg import cg


def _cast_format(A, dtype):
    """Cast a format's value arrays to `dtype` (index arrays kept).

    Delegates to `formats.convert.cast_values`, which casts *host-side*
    when a host cache exists, preserving the `_host_cache` attribute (a
    bare `jax.tree.map` rebuild drops object attributes)."""
    from ..formats.convert import cast_values

    return cast_values(A, dtype)


def mixed_precision_dc(
    A,
    b,
    x0=None,
    *,
    inner_solver: Optional[Callable] = None,
    inner_dtype=jnp.float32,
    inner_kwargs: Optional[dict] = None,
    abs_tol: float = 1e-15,
    rel_tol: float = 1e-6,
    div_tol: float = 1e8,
    max_iter: int = 50,
):
    """Solve A x = b: outer defect correction in b's dtype (f64 by default),
    inner solves in `inner_dtype` (f32 by default).

    `inner_solver(A_low, r_low, **inner_kwargs) -> (d, info)` — any
    rocalution_tpu solver; defaults to CG (the reference pairs DC with any
    inner solver via Set(Solver_L)). Returns ``(x, SolverInfo)``.
    """
    solver = inner_solver or cg
    ikw = dict(inner_kwargs or {})
    ikw.setdefault("rel_tol", 1e-3)
    ikw.setdefault("max_iter", 10000)

    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    # Build/Solve split (reference: MixedPrecisionDC::Build casts + builds
    # once, Solve reuses — mixed_precision.cpp): the hoisted jits and the
    # cast operator are cached ON the operator object, so repeated solves
    # pay tracing/compile/upload once, like any built reference solver.
    key = (str(jnp.dtype(inner_dtype)),
           getattr(solver, "__name__", repr(solver)),
           tuple(sorted(ikw.items())), b.shape, str(b.dtype))
    cache = getattr(A, "_mpdc_cache", None)
    if cache is not None and cache[0] == key:
        residual, inner = cache[1], cache[2]
    else:
        op = as_operator(A)
        A_low = _cast_format(A, inner_dtype)

        from ..utils.hoist import hoisted_jit

        residual = hoisted_jit(lambda b, x: b - op(x), b, x)
        inner = hoisted_jit(
            lambda rl: solver(A_low, rl, **ikw)[0], b.astype(inner_dtype)
        )
        object.__setattr__(A, "_mpdc_cache", (key, residual, inner))

    r = residual(b, x)
    init_res = float(jnp.linalg.norm(r))
    res = init_res
    status, it = 0, 0
    history = [init_res]
    while it < max_iter:
        if not np.isfinite(res):
            status = 0
            break
        if res <= abs_tol:
            status = 1
            break
        if res / init_res <= rel_tol:
            status = 2
            break
        if res / init_res >= div_tol:
            status = 3
            break
        d = inner(r.astype(inner_dtype))
        x = x + d.astype(b.dtype)
        r = residual(b, x)
        res = float(jnp.linalg.norm(r))
        it += 1
        history.append(res)
    else:
        status = 4

    hist = jnp.asarray(history)
    info = SolverInfo(
        iterations=jnp.asarray(it),
        status=jnp.asarray(status),
        init_res=jnp.asarray(init_res),
        final_res=jnp.asarray(res),
        history=hist,
    )
    return x, info
