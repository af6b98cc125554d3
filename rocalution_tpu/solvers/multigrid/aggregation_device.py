"""Device-side PMIS aggregation (the hip_rsamg/AMGPMISAggregate analog).

The reference runs its PMIS-style setup kernels on the GPU
(src/base/hip/hip_rsamg_csr.cpp, hip_kernels_rsamg_csr.hpp: strong-influence
hashes, unassigned->coarse, coarse-edge passes). This is the JAX
formulation: everything is segment-max sweeps over the strength graph's
edge list inside one `lax.while_loop`, so the whole aggregation runs as a
single XLA program on device.

Key reformulation: the distance-2 Luby test needs
    max over k in N2(i)\\{i} of w_k  <  w_i.
Materializing N2 = C + C@C (data-dependent nnz) is host work; instead run
TWO rounds of edge segment-max:
    m1(j) = max_{k in N(j)} key(k)
    m2(i) = max_{j in N(i)} max(key(j), m1(j))
m2 includes w_i through the path i->j->i, so with unique keys the PMIS
condition is exactly `key(i) >= m2(i)` (isolated nodes: m2 = int-min, also
selected) — no distance-2 pattern ever built.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

def _seg_max(vals, rows, n):
    return jax.ops.segment_max(vals, rows, num_segments=n,
                               indices_are_sorted=True)


def pmis_aggregate_device(indptr, indices, n: int, w) -> jnp.ndarray:
    """PMIS aggregation on device. `indptr`/`indices`: the (symmetric)
    strength graph in CSR; `w`: unique integer keys (a permutation).
    Returns agg ids (n,) int32, -1 never present (leftovers become
    singletons) — same contract as aggregation.pmis_aggregate."""
    indptr = np.asarray(indptr, np.int64)
    rows = jnp.asarray(
        np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr)))
    cols = jnp.asarray(np.asarray(indices, np.int32))
    # int32 keys: float32 cannot hold unique keys past 2^24 nodes
    w = jnp.asarray(w, jnp.int32)

    def luby_cond(state):
        candidate, _ = state
        return jnp.any(candidate)

    def luby_body(state):
        candidate, is_root = state
        key = jnp.where(candidate, w, jnp.int32(-1))
        m1 = _seg_max(key[cols], rows, n)
        km = jnp.maximum(key, m1)
        m2 = _seg_max(km[cols], rows, n)
        sel = candidate & (key >= m2)
        is_root = is_root | sel
        # knock out the selected roots' distance-<=2 neighborhood
        s1 = _seg_max(sel[cols].astype(jnp.int32), rows, n) > 0
        s12 = sel | s1
        s2 = _seg_max(s12[cols].astype(jnp.int32), rows, n) > 0
        candidate = candidate & ~(s12 | s2)
        return candidate, is_root

    candidate0 = jnp.ones(n, bool)
    is_root0 = jnp.zeros(n, bool)
    _, is_root = jax.lax.while_loop(luby_cond, luby_body,
                                    (candidate0, is_root0))

    root_id = jnp.cumsum(is_root.astype(jnp.int32)) - 1
    agg = jnp.where(is_root, root_id, -1)

    # neighbors join adjacent aggregates (round 1 = neighbors of roots,
    # further rounds = leftovers; reference coarse-edge passes)
    def join(agg, _):
        nbr = _seg_max(agg[cols], rows, n)
        return jnp.where((agg < 0) & (nbr >= 0), nbr, agg), None

    agg, _ = jax.lax.scan(join, agg, None, length=4)

    # remaining isolates become singleton aggregates
    na = jnp.max(agg) + 1
    left = agg < 0
    extra = jnp.cumsum(left.astype(jnp.int32)) - 1
    return jnp.where(left, na + extra, agg).astype(jnp.int32)


def pmis_coarsening_device(Sgraph, seed: int = 0) -> np.ndarray:
    """RS PMIS C/F splitting on device (reference: RSPMISCoarsening,
    hip_rsamg_csr.cpp — random-hash Luby rounds + dependent->F passes).
    Distance-1 Luby over the symmetrized strength graph, F-marking via an
    unsorted segment-max over the transpose edge list; one while_loop.
    Returns cfmap (True = C), matching rs.pmis_coarsening's contract."""
    import scipy.sparse as sp

    n = Sgraph.shape[0]
    ST = Sgraph.T.tocsr()
    G = ((Sgraph + ST) > 0).astype(np.int8).tocsr()
    G.sort_indices()
    rng = np.random.default_rng(seed)
    # weight = #dependents * n + random tiebreak, as one unique int64 key
    lam = np.diff(ST.indptr).astype(np.int64)
    w_np = lam * n + rng.permutation(n)
    g_rows = jnp.asarray(
        np.repeat(np.arange(n, dtype=np.int32), np.diff(G.indptr)))
    g_cols = jnp.asarray(G.indices.astype(np.int32))
    st_rows = jnp.asarray(
        np.repeat(np.arange(n, dtype=np.int32), lam))
    st_cols = jnp.asarray(ST.indices.astype(np.int32))
    w = jnp.asarray(w_np)
    iso = jnp.asarray(np.diff(G.indptr) == 0)

    # 0 undecided, 1 C, 2 F
    cf0 = jnp.where(iso, jnp.int8(1), jnp.int8(0))

    def cond(state):
        cf, progress = state
        return jnp.any(cf == 0) & progress

    def body(state):
        cf, _ = state
        und = cf == 0
        key = jnp.where(und, w, jnp.int64(-1))
        m1 = _seg_max(key[g_cols], g_rows, n)
        sel = und & (key > m1)
        cf = jnp.where(sel, jnp.int8(1), cf)
        # undecided points depending on a new C point become F
        hit = jax.ops.segment_max(
            sel[st_rows].astype(jnp.int32), st_cols, num_segments=n) > 0
        cf = jnp.where((cf == 0) & hit, jnp.int8(2), cf)
        return cf, jnp.any(sel)

    cf, _ = jax.lax.while_loop(cond, body, (cf0, jnp.bool_(True)))
    cf = jnp.where(cf == 0, jnp.int8(1), cf)   # stall safety: rest -> C
    return np.asarray(cf) == 1


def pmis_aggregate_jit(C, seed: int = 0) -> np.ndarray:
    """Host wrapper matching aggregation.pmis_aggregate's signature:
    takes a scipy strength graph, runs the device kernel, returns numpy."""
    n = C.shape[0]
    if n == 0 or C.nnz == 0:
        return np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(seed)
    w = rng.permutation(n)
    Cs = C.tocsr()
    Cs.sort_indices()
    agg = pmis_aggregate_device(Cs.indptr, Cs.indices, n, w)
    from .aggregation import _relabel_by_first_row

    # row-order coarse numbering keeps P/R/Ac banded (see aggregation.py)
    return _relabel_by_first_row(np.asarray(agg).astype(np.int64))
