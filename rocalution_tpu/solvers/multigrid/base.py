"""Multigrid cycle machinery.

Reference parity: BaseMultiGrid (src/solvers/multigrid/base_multigrid.{hpp,
cpp}) — V/W/F/K cycles (`_cycle` enum base_multigrid.hpp:34, Vcycle_
base_multigrid.cpp:720-916: pre-smooth, restrict, recurse, prolong+correct,
post-smooth), smoother/coarse-solver slots, and MultiGrid (multigrid.{hpp,
cpp}) — the geometric variant with a user-supplied hierarchy
(SetOperatorHierarchy/SetRestrictOperator/SetProlongOperator).

Design: a hierarchy has static shapes once built, so the ENTIRE
cycle — every level's smoothing, restriction, prolongation, and the coarse
dense solve — composes into one jittable closure (Python recursion unrolls
at trace time). Used as a preconditioner it rides inside the Krylov
`lax.while_loop`; as a standalone solver it is a FixedPoint iteration with
the cycle as M (exactly the reference's MG solve structure).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ...formats import CSR
from ...ops.spmv import spmv
from ...precond.jacobi import extract_diagonal
from ..direct import qr_factor
from ..fixed_point import fixed_point
from ..iter_ctrl import IterationControl


@dataclasses.dataclass(frozen=True)
class MGLevel:
    """One grid level: operator + transfer ops + smoother closure."""

    A: object                       # operator (format pytree)
    P: Optional[object]             # prolongation (None on coarsest)
    R: Optional[object]             # restriction (None on coarsest)
    smooth: Optional[Callable]      # (b, x, sweeps) -> x


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    levels: List[MGLevel]
    coarse_solve: Callable          # (b,) -> x on the coarsest level
    pre_sweeps: int = 1
    post_sweeps: int = 2
    cycle: str = "V"                # V | W | F | K
    # energy-minimizing correction scaling (reference: SetScaling,
    # base_multigrid.cpp:766-789/891-897): scale the pre-smoothed iterate
    # and the prolonged correction by <w,t>/<t,At>.
    scaling: bool = False
    # number of COARSEST levels computed on the host via a pure_callback
    # (reference: SetHostLevels, base_multigrid.cpp:802-813 — coarse grids
    # move to host where tiny ops beat accelerator latency).
    host_levels: int = 0

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def operator_sizes(self):
        return [lv.A.shape[0] for lv in self.levels]

    def with_options(self, **kw) -> "Hierarchy":
        """Return a copy with cycle options changed (cycle/scaling/
        host_levels/pre_sweeps/post_sweeps) — the analog of the reference's
        SetCycle/SetScaling/SetHostLevels setters."""
        return dataclasses.replace(self, **kw)


def jacobi_smoother(A, omega: float = 2.0 / 3.0) -> Callable:
    """Default smoother: damped-Jacobi FixedPoint sweeps (reference:
    BaseAMG::BuildSmoothers default FixedPoint+Jacobi, base_amg.cpp)."""
    from ...precond.jacobi import inverse_diagonal_host

    host = inverse_diagonal_host(A)
    if host is not None:          # setup stays host-side (no eager compiles)
        inv_d = jnp.asarray(omega * host)
    else:
        d = extract_diagonal(A)
        inv_d = jnp.where(d != 0, omega / jnp.where(d == 0, 1.0, d), omega)

    def smooth(b, x, sweeps):
        for _ in range(sweeps):
            x = x + inv_d * (b - spmv(A, x))
        return x

    return smooth


def precond_smoother(A, M: Callable, omega: float = 1.0) -> Callable:
    """Smoother from any preconditioner closure (reference: manual smoothers
    via SetSmoother — e.g. multicolored GS)."""

    def smooth(b, x, sweeps):
        for _ in range(sweeps):
            x = x + omega * M(b - spmv(A, x))
        return x

    return smooth


def build_hierarchy(
    ops: Sequence,
    prolongs: Sequence,
    restricts: Optional[Sequence] = None,
    *,
    smoother: Optional[Callable] = None,
    coarse_solve: Optional[Callable] = None,
    pre_sweeps: int = 1,
    post_sweeps: int = 2,
    cycle: str = "V",
) -> Hierarchy:
    """Assemble a Hierarchy from operator + transfer lists (the geometric-MG
    entry point; AMG builders call this too). `smoother(A) -> closure`
    defaults to damped Jacobi; `coarse_solve` defaults to dense QR."""
    from ...formats.base import on_device

    if restricts is None:
        restricts = [P.transpose_host() for P in prolongs]
    ops = [on_device(A) for A in ops]
    prolongs = [on_device(P) for P in prolongs]
    restricts = [on_device(R) for R in restricts]
    mk_smooth = smoother or jacobi_smoother
    levels = []
    for i, A in enumerate(ops):
        last = i == len(ops) - 1
        levels.append(MGLevel(
            A=A,
            P=None if last else prolongs[i],
            R=None if last else restricts[i],
            smooth=None if last else mk_smooth(A),
        ))
    if coarse_solve is None:
        coarse_solve = _DeferredCoarse(ops[-1])
    return Hierarchy(levels, coarse_solve, pre_sweeps, post_sweeps, cycle)


class _DeferredCoarse:
    """Coarse-solve closure whose factorization runs on FIRST USE, not at
    hierarchy assembly: an f64 setup hierarchy that is immediately
    `convert_hierarchy`-ed to f32 would otherwise pay a dense QR (device
    compile + factor) that nothing ever calls. `cycle_closure` resolves it
    at closure-build time (untraced)."""

    def __init__(self, A):
        self._A = A
        self._fn = None

    def resolve(self) -> Callable:
        if self._fn is None:
            self._fn = default_coarse_solve(self._A)
        return self._fn

    def __call__(self, b):
        return self.resolve()(b)


# dense coarse factorization above this size would allocate O(n^2) — a
# 263k-row coarse level (seen when aggregation stalled) means 518 GiB
_DENSE_COARSE_MAX = 8192


def default_coarse_solve(A) -> Callable:
    """Coarsest-level solve: dense QR when small (reference default
    LU/redundant, base_amg.cpp), else a fixed-budget Jacobi-CG closure —
    never a dense factorization of a large operator."""
    if A.shape[0] <= _DENSE_COARSE_MAX:
        return qr_factor(A)
    from ...utils.log import log_info

    log_info(
        f"AMG coarse level has {A.shape[0]} rows (> {_DENSE_COARSE_MAX}); "
        "using an iterative (CG+Jacobi) coarse solve instead of dense QR"
    )
    from ...precond.jacobi import inverse_diagonal
    from ..krylov.cg import cg

    inv_d = inverse_diagonal(A)
    # tolerance scaled to the operator dtype: 1e-10 is unreachable in f32
    # and would burn the full iteration budget every cycle application.
    # NOTE a truncated inner Krylov makes the cycle a VARIABLE
    # preconditioner — pair with FCG/FGMRES as the outer solver when this
    # path triggers (plain CG only tolerates it by luck).
    import numpy as _np

    rel_tol = 1e-10 if _np.dtype(A.dtype) == _np.float64 else 1e-6

    def solve(b):
        x, _ = cg(A, b, M=lambda r: inv_d * r, rel_tol=rel_tol,
                  max_iter=200)
        return x

    return solve


def rebuild_hierarchy_numeric(h: Hierarchy, A_new, *,
                              plans=None) -> Hierarchy:
    """ReBuildNumeric analog (reference: Solver::ReBuildNumeric,
    solver.hpp — refresh the hierarchy for NEW VALUES on the same
    nonzero structure): transfers P/R are kept frozen and every level
    operator is recomputed as the Galerkin product R·A·P (the standard
    numeric-rebuild policy), smoothers and the coarse solve rebuilt
    against the refreshed operators. Setup cost = triple products only —
    no strength graphs, no aggregation.

    `plans` (from `make_galerkin_plans(h)`): frozen symbolic patterns per
    level — the numeric Galerkin then runs ON DEVICE (gather + segment_sum
    over precomputed triple lists, ops/spgemm.triple_product_plan), the
    analog of the reference reusing its csrgemm info on rebuild."""
    from ...formats import to_csr

    levels = []
    A = to_csr(A_new)
    for li, lv in enumerate(h.levels):
        if lv.P is None:
            levels.append(MGLevel(A=A, P=None, R=None, smooth=None))
            break
        levels.append(MGLevel(A=A, P=lv.P, R=lv.R,
                              smooth=jacobi_smoother(A)))
        if plans is not None:
            pat, update = plans[li]
            A = dataclasses.replace(pat, data=update(A.data))
        else:
            from ...ops.spgemm import triple_product

            A = triple_product(to_csr(lv.R), A, to_csr(lv.P))
    return Hierarchy(levels, _DeferredCoarse(levels[-1].A), h.pre_sweeps,
                     h.post_sweeps, h.cycle, h.scaling, h.host_levels)


def make_galerkin_plans(h: Hierarchy):
    """One frozen-symbolic Galerkin plan per non-coarsest level (see
    `rebuild_hierarchy_numeric`): the host symbolic pass runs once here;
    every later numeric rebuild is device-only."""
    from ...formats import to_csr
    from ...ops.spgemm import triple_product_plan

    plans = []
    for lv in h.levels:
        if lv.P is None:
            break
        plans.append(triple_product_plan(to_csr(lv.R), to_csr(lv.A),
                                         to_csr(lv.P)))
    return plans


def convert_hierarchy(h: Hierarchy, fmt: str = "auto",
                      max_diags: int = 96, dtype=None) -> Hierarchy:
    """Convert level operators to a faster device format (reference:
    SetOperatorFormat/DefaultSmootherOperatorFormat on BaseAMG — per-level
    format control). "auto" picks DIA when the level's band has at most
    `max_diags` distinct offsets (the gather-free path), else keeps CSR.
    `dtype` additionally casts every level's values (pair an f32 hierarchy
    with an f64 outer defect correction when full precision is needed).
    Smoothers and the coarse solver are rebuilt against the converted
    operators."""
    from ...formats import DIA, convert
    from ...formats.base import get_host

    def cast(M):
        if dtype is None or M is None:
            return M
        from ...formats.convert import cast_values

        return cast_values(M, dtype)

    new_levels = []
    for lv in h.levels:
        # cast FIRST so a format conversion only ever materializes the
        # final dtype
        A = cast(lv.A)
        if fmt in ("auto", "DIA") and not isinstance(A, DIA) and hasattr(
                A, "numpy_triplet"):
            idx = get_host(A, "indices").astype(np.int64)
            rows = get_host(A, "row_ids").astype(np.int64)
            ndiag = len(np.unique(idx - rows))
            if fmt == "DIA" or ndiag <= max_diags:
                A = convert(A, "DIA")
        new_levels.append(MGLevel(
            A=A, P=cast(lv.P), R=cast(lv.R),
            smooth=None if lv.smooth is None else jacobi_smoother(A),
        ))
    coarse = h.coarse_solve
    if dtype is not None:
        coarse = _DeferredCoarse(new_levels[-1].A)
    return Hierarchy(new_levels, coarse, h.pre_sweeps,
                     h.post_sweeps, h.cycle, h.scaling, h.host_levels)


def _energy_factor(w, t, At):
    """Energy-minimizing scale <w,t>/<t,At>, 1 on zero denominator
    (reference: base_multigrid.cpp:766-789)."""
    num = jnp.sum(w * t)
    den = jnp.sum(t * At)
    return jnp.where(den == 0, 1.0, num / jnp.where(den == 0, 1.0, den))


def cycle_closure(h: Hierarchy) -> Callable:
    """The multigrid cycle as a preconditioner closure r -> e ≈ A^{-1} r.

    Python recursion unrolls the whole cycle into one XLA program
    (reference: Vcycle_/Wcycle_/Fcycle_/Kcycle_, base_multigrid.cpp:720-981).
    With `h.scaling` the pre-smoothed iterate (levels 0<l<L-2) and the
    prolonged correction (levels l<L-2) are energy-min scaled; with
    `h.host_levels` the coarsest levels run on the host inside a
    pure_callback (base_multigrid.cpp:802-813 MoveToHost analog).
    """
    cyc = h.cycle.upper()
    L = h.num_levels
    boundary = max(0, L - h.host_levels) if h.host_levels > 0 else None
    host_entry = _host_subtree(h, boundary) if boundary is not None else None
    # resolve a deferred coarse factorization NOW (untraced): under trace
    # the QR would be baked into the program and re-run every application
    coarse = (h.coarse_solve.resolve()
              if isinstance(h.coarse_solve, _DeferredCoarse)
              else h.coarse_solve)

    def level_apply(l: int, b, mode: str):
        lv = h.levels[l]
        if boundary is not None and l == boundary:
            # `mode` is static at trace time — close over it; only the
            # vector crosses the host boundary
            return jax.pure_callback(
                functools.partial(host_entry, mode=mode),
                jax.ShapeDtypeStruct(b.shape, b.dtype), b,
                vmap_method="sequential",
            )
        if lv.P is None:
            return coarse(b)
        x = lv.smooth(b, jnp.zeros_like(b), h.pre_sweeps)
        if h.scaling and 0 < l < L - 2 and h.pre_sweeps > 0:
            x = x * _energy_factor(b, x, spmv(lv.A, x))
        res_f = b - spmv(lv.A, x)
        res = spmv(lv.R, res_f)
        Ac = h.levels[l + 1].A
        if l + 2 == h.num_levels or mode == "V":
            e = level_apply(l + 1, res, "V" if mode == "F" else mode)
        elif mode == "W":
            e = level_apply(l + 1, res, "W")
            e = e + level_apply(l + 1, res - spmv(Ac, e), "W")
        elif mode == "F":
            # F-cycle: one F recursion then one V recursion
            e = level_apply(l + 1, res, "F")
            e = e + level_apply(l + 1, res - spmv(Ac, e), "V")
        elif mode == "K":
            # K-cycle: two FCG steps on the coarse system, preconditioned
            # by the deeper cycle (Notay; reference SetKcycleFull)
            e = _fcg_steps(Ac, res, lambda r: level_apply(l + 1, r, "K"), 2)
        else:
            raise ValueError(f"unknown cycle {mode!r}")
        t = spmv(lv.P, e)
        if h.scaling and l < L - 2:
            # level 0 numerator uses the post-pre-smooth residual, deeper
            # levels the level rhs (base_multigrid.cpp:862-897)
            w = res_f if l == 0 else b
            x = x + _energy_factor(w, t, spmv(lv.A, t)) * t
        else:
            x = x + t
        return lv.smooth(b, x, h.post_sweeps)

    return lambda r: level_apply(0, r, cyc)


def _host_subtree(h: Hierarchy, boundary: int) -> Callable:
    """Numpy/scipy execution of levels >= `boundary` — called through
    jax.pure_callback so coarse grids run on the host CPU while the fine
    levels stay on the device (SetHostLevels analog). Mirrors level_apply's
    recursion exactly."""
    import scipy.linalg as sla
    import scipy.sparse as sp

    from ...formats.base import get_host
    from ...formats.convert import to_csr

    mats = {}   # (level, name) -> scipy matrix / numpy diag

    def as_sp(M):
        key = id(M)
        if key not in mats:
            c = to_csr(M)
            d, i, p = c.numpy_triplet()
            mats[key] = sp.csr_matrix((d, i, p), shape=c.shape)
        return mats[key]

    levels = h.levels
    Ac = to_csr(levels[-1].A)
    dc, ic, pc = Ac.numpy_triplet()
    dense = sp.csr_matrix((dc, ic, pc), shape=Ac.shape).toarray()
    lu = sla.lu_factor(dense)
    inv_diags = {}

    def smooth(l, b, x, sweeps, omega=2.0 / 3.0):
        A = as_sp(levels[l].A)
        if l not in inv_diags:
            d = A.diagonal()
            inv_diags[l] = np.where(d != 0, omega / np.where(d == 0, 1, d),
                                    omega)
        for _ in range(sweeps):
            x = x + inv_diags[l] * (b - A @ x)
        return x

    def factor(w, t, At):
        den = float(np.dot(t, At))
        return 1.0 if den == 0 else float(np.dot(w, t)) / den

    def apply_(l, b, mode):
        lv = levels[l]
        if lv.P is None:
            return sla.lu_solve(lu, b.astype(dense.dtype)).astype(b.dtype)
        x = smooth(l, b, np.zeros_like(b), h.pre_sweeps)
        if h.scaling and 0 < l < len(levels) - 2 and h.pre_sweeps > 0:
            x = x * factor(b, x, as_sp(lv.A) @ x)
        res_f = b - as_sp(lv.A) @ x
        res = as_sp(lv.R) @ res_f
        if l + 2 == len(levels) or mode == "V":
            e = apply_(l + 1, res, "V" if mode == "F" else mode)
        elif mode == "W":
            e = apply_(l + 1, res, "W")
            e = e + apply_(l + 1, res - as_sp(levels[l + 1].A) @ e, "W")
        elif mode == "F":
            e = apply_(l + 1, res, "F")
            e = e + apply_(l + 1, res - as_sp(levels[l + 1].A) @ e, "V")
        else:  # K on host: collapse to V (host subtree is the tail levels)
            e = apply_(l + 1, res, "V")
        t = as_sp(lv.P) @ e
        if h.scaling and l < len(levels) - 2:
            w = res_f if l == 0 else b
            x = x + factor(w, t, as_sp(lv.A) @ t) * t
        else:
            x = x + t
        return smooth(l, b, x, h.post_sweeps)

    def entry(b, mode="V"):
        b = np.asarray(b)
        return apply_(boundary, b, str(mode)).astype(b.dtype)

    return entry


def _fcg_steps(A, b, M: Callable, steps: int):
    """Fixed-step flexible CG (no convergence checks) — K-cycle smoother."""
    x = jnp.zeros_like(b)
    r = b
    p = None
    z_prev = None
    r_prev = None
    for _ in range(steps):
        z = M(r)
        if p is None:
            p = z
            rho = jnp.sum(r * z)
        else:
            rho_new = jnp.sum(r * z)
            beta = jnp.where(rho == 0, 0.0,
                             (rho_new - jnp.sum(z * r_prev))
                             / jnp.where(rho == 0, 1.0, rho))
            p = z + beta * p
            rho = rho_new
        q = spmv(A, p)
        denom = jnp.sum(p * q)
        alpha = jnp.where(denom == 0, 0.0, rho / jnp.where(denom == 0, 1.0, denom))
        x = x + alpha * p
        r_prev = r
        r = r - alpha * q
    return x


def mg_solve(h: Hierarchy, b, x0=None, *,
             ctrl: Optional[IterationControl] = None, **kwargs):
    """Standalone multigrid solve: FixedPoint iteration with the cycle as
    preconditioner (reference: BaseMultiGrid::Solve cycling until
    tolerance). Returns (x, SolverInfo)."""
    M = cycle_closure(h)
    return fixed_point(h.levels[0].A, b, x0, M,
                       omega=1.0, ctrl=ctrl, **kwargs)
