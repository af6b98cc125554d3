"""On-device iteration control.

Reference parity: `IterationControl` (src/solvers/iter_ctrl.cpp). Semantics
mirrored exactly — statuses 0=none (incl. NaN/Inf stop), 1=absolute, 2=relative,
3=divergence, 4=max-iter; criteria ordering and min-iteration gating follow
CheckResidual (iter_ctrl.cpp:195-248); InitResidual (:89-122) may terminate
immediately on NaN or on the absolute criterion.

Design: instead of a host-side object whose every check forces a
device→host sync per Krylov iteration (the reference's hidden cost), the whole
state machine is a small pytree carried through `lax.while_loop`, so the entire
solve — convergence control included — runs on-device in one XLA program.
Residual history is recorded into a fixed-size on-device buffer.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp


class IterState(NamedTuple):
    iteration: jnp.ndarray      # int32 scalar
    init_res: jnp.ndarray      # f64/f32 scalar
    current_res: jnp.ndarray   # scalar
    status: jnp.ndarray        # int32: 0 running/none, 1 abs, 2 rel, 3 div, 4 maxiter
    running: jnp.ndarray       # bool: loop-continue flag
    history: jnp.ndarray       # (max_iter+1,) residual history (NaN-padded)


@dataclasses.dataclass(frozen=True)
class IterationControl:
    """Static criteria (analog IterationControl::Init, defaults from
    iter_ctrl.cpp:52-56)."""

    abs_tol: float = 1e-15
    rel_tol: float = 1e-6
    div_tol: float = 1e8
    min_iter: int = 0
    max_iter: int = 1000000
    record_history: bool = False

    def _hist_len(self) -> int:
        return (self.max_iter + 1) if self.record_history else 1

    def init_residual(self, res, res_dtype=None) -> IterState:
        """Analog InitResidual (iter_ctrl.cpp:89): may stop immediately on
        NaN/Inf or the absolute criterion."""
        res = jnp.asarray(res)
        dtype = res_dtype or res.dtype
        res = res.astype(dtype)
        bad = jnp.logical_not(jnp.isfinite(res))
        abs_hit = jnp.abs(res) <= self.abs_tol
        status = jnp.where(abs_hit & ~bad, 1, 0).astype(jnp.int32)
        running = jnp.logical_not(bad | abs_hit)
        history = jnp.full((self._hist_len(),), jnp.nan, dtype=dtype)
        if self.record_history:
            history = history.at[0].set(res)
        return IterState(
            iteration=jnp.zeros((), jnp.int32),
            init_res=res,
            current_res=res,
            status=status,
            running=running,
            history=history,
        )

    def check_residual(self, state: IterState, res) -> IterState:
        """Analog CheckResidual (iter_ctrl.cpp:195-248). Pure function: returns
        the next state; `state.running` becomes False when the solver must stop."""
        res = jnp.asarray(res).astype(state.current_res.dtype)
        iteration = state.iteration + 1
        history = state.history
        if self.record_history:
            history = history.at[jnp.minimum(iteration, self.max_iter)].set(res)

        bad = jnp.logical_not(jnp.isfinite(res))
        past_min = iteration >= self.min_iter
        abs_hit = past_min & (jnp.abs(res) <= self.abs_tol)
        rel_hit = past_min & (res / state.init_res <= self.rel_tol)
        max_hit = past_min & (iteration >= self.max_iter)
        div_hit = res / state.init_res >= self.div_tol

        # Priority order follows the reference: NaN (no status), abs, rel,
        # maxiter, then divergence.
        status = jnp.where(
            bad,
            0,
            jnp.where(
                abs_hit,
                1,
                jnp.where(
                    rel_hit, 2, jnp.where(max_hit, 4, jnp.where(div_hit, 3, 0))
                ),
            ),
        ).astype(jnp.int32)
        stop = bad | abs_hit | rel_hit | max_hit | div_hit
        return IterState(
            iteration=iteration,
            init_res=state.init_res,
            current_res=res,
            status=status,
            running=jnp.logical_not(stop),
            history=history,
        )


class SolverInfo(NamedTuple):
    """Solve outcome returned to the user (analog of the accessors
    GetIterationCount/GetCurrentResidual/GetSolverStatus, solver.hpp:410-424)."""

    iterations: jnp.ndarray
    status: jnp.ndarray
    init_res: jnp.ndarray
    final_res: jnp.ndarray
    history: jnp.ndarray

    @property
    def converged(self):
        return (self.status == 1) | (self.status == 2)


def info_from_state(state: IterState) -> SolverInfo:
    return SolverInfo(
        iterations=state.iteration,
        status=state.status,
        init_res=state.init_res,
        final_res=state.current_res,
        history=state.history,
    )


STATUS_NAMES = {
    0: "no criteria reached / NaN-Inf stop",
    1: "absolute tolerance reached",
    2: "relative tolerance reached",
    3: "divergence tolerance reached",
    4: "maximum iterations reached",
}
