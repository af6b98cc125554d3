"""Hoist closure-captured operator arrays out of jitted solves.

Solvers and preconditioners in this package are CLOSURES over concrete
operator pytrees (matching the reference's object model, where a built
solver owns its operator). When a user jits such a closure, every captured
array is serialized into the HLO as a constant: a 2M-unknown AMG hierarchy
puts hundreds of MB into the program, which costs compile time and memory
on any backend.

`hoisted_jit` wraps `jax.closure_convert`: the function is traced once
abstractly, every captured array becomes a formal argument (device buffers,
transferred once), and the returned callable hides the plumbing.
"""

from __future__ import annotations

import jax
from jax import tree_util


def hoisted_jit(fn, *example_args):
    """jit `fn` with its closure-captured arrays lifted to arguments.

    `example_args`: concrete or ShapeDtypeStruct examples of fn's inputs.
    Returns a callable with fn's signature whose compiled HLO contains no
    large constants; the captured arrays ride along as device buffers.

    Implementation: trace once with `make_jaxpr` (its `consts` are exactly
    the closure-captured concrete arrays — `jax.closure_convert` hoists
    only TRACED captures, not concrete ones), then jit an `eval_jaxpr`
    wrapper that takes those consts as ordinary arguments.

    >>> M = cycle_closure(hier)                      # captures the levels
    >>> solve = hoisted_jit(lambda b: cg(A, b, M=M)[0], b)
    >>> x = solve(b)                                 # compiles small HLO
    """
    flat_args, in_tree = tree_util.tree_flatten(example_args)
    out_store = []

    def flat_fn(*flat):
        args = tree_util.tree_unflatten(in_tree, flat)
        out = fn(*args)
        flat_out, out_tree = tree_util.tree_flatten(out)
        out_store.append(out_tree)
        return flat_out

    closed_jaxpr = jax.make_jaxpr(flat_fn)(*flat_args)
    out_tree = out_store[-1]
    consts = jax.device_put(list(closed_jaxpr.consts))

    @jax.jit
    def run(consts, *flat):
        return jax.core.eval_jaxpr(closed_jaxpr.jaxpr, consts, *flat)

    def call(*args):
        flat = tree_util.tree_flatten(args)[0]
        return tree_util.tree_unflatten(out_tree, run(consts, *flat))

    return call
