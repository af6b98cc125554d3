"""Level-1 vector operations.

Reference parity: the LocalVector op surface (src/base/local_vector.hpp:68-670)
and its host/HIP kernels (host_vector.cpp, hip_vector.cpp via rocBLAS). Here
these are single jnp expressions — XLA fuses chains of them into one
elementwise pass, which is the idiomatic replacement for rocBLAS calls. Complex-aware like the
reference (src/utils/math_functions.*).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dot(x, y):
    """Conjugated dot <x,y> (reference: LocalVector::Dot)."""
    return jnp.vdot(x, y)


def dot_nonconj(x, y):
    """Non-conjugated dot (reference: LocalVector::DotNonConj)."""
    return jnp.sum(x * y)


def norm(x):
    """Euclidean norm (reference: LocalVector::Norm)."""
    return jnp.sqrt(jnp.real(jnp.vdot(x, x)))


def asum(x):
    """Sum of absolute values (reference: LocalVector::Asum)."""
    return jnp.sum(jnp.abs(x))


def amax(x):
    """Index and value of max-|x| entry (reference: LocalVector::Amax)."""
    idx = jnp.argmax(jnp.abs(x))
    return idx, x[idx]


def reduce_sum(x):
    """Sum reduction (reference: LocalVector::Reduce)."""
    return jnp.sum(x)


def scale(x, alpha):
    return alpha * x


def add_scale(x, y, alpha):
    """x + alpha*y (reference: LocalVector::AddScale — axpy)."""
    return x + alpha * y


def scale_add(x, y, alpha):
    """alpha*x + y (reference: LocalVector::ScaleAdd)."""
    return alpha * x + y


def scale_add_scale(x, y, alpha, beta):
    """alpha*x + beta*y (reference: LocalVector::ScaleAddScale)."""
    return alpha * x + beta * y


def scale_add2(x, y, z, alpha, beta, gamma):
    """alpha*x + beta*y + gamma*z (reference: LocalVector::ScaleAdd2)."""
    return alpha * x + beta * y + gamma * z


def pointwise_mult(x, y, z=None):
    """x .* y (or y .* z) (reference: LocalVector::PointWiseMult)."""
    if z is None:
        return x * y
    return y * z


def power(x, p):
    """Elementwise power (reference: LocalVector::Power)."""
    return jnp.power(x, p)


def inclusive_sum(x):
    """Inclusive prefix sum (reference: LocalVector::InclusiveSum)."""
    return jnp.cumsum(x)


def exclusive_sum(x):
    """Exclusive prefix sum (reference: LocalVector::ExclusiveSum)."""
    c = jnp.cumsum(x)
    return c - x


def permute(x, perm):
    """out[perm[i]] = x[i] (reference: LocalVector::Permute semantics)."""
    return jnp.zeros_like(x).at[perm].set(x)


def permute_backward(x, perm):
    """out[i] = x[perm[i]] (reference: LocalVector::PermuteBackward)."""
    return x[perm]


def get_index_values(x, idx):
    """Gather (reference: LocalVector::GetIndexValues — halo gather)."""
    return x[idx]


def set_index_values(x, idx, values):
    """Scatter (reference: LocalVector::SetIndexValues — halo scatter)."""
    return x.at[idx].set(values)


def add_index_values(x, idx, values):
    return x.at[idx].add(values)


def sigma_norm(x, sigma):  # pragma: no cover - utility
    return jnp.sqrt(jnp.real(jnp.vdot(x, x)) + sigma)


def restriction(x_fine, fmap, n_coarse: int):
    """Map-based restriction: coarse[fmap[i]] += fine[i] for fmap[i] != -1
    (reference: LocalVector::Restriction, host_vector.cpp:1415-1439) —
    one segment_sum with -1 entries routed to a dropped slot."""
    safe = jnp.where(fmap < 0, n_coarse, fmap)
    return jax.ops.segment_sum(
        jnp.where(fmap < 0, 0, x_fine), safe, num_segments=n_coarse + 1
    )[:n_coarse]


def prolongation(x_coarse, fmap):
    """Map-based prolongation: fine[i] = coarse[fmap[i]], 0 where the map
    is -1 (reference: LocalVector::Prolongation, host_vector.cpp:1441+)."""
    safe = jnp.maximum(fmap, 0)
    return jnp.where(fmap < 0, 0, x_coarse[safe])


def set_random_uniform(key, n, low=-1.0, high=1.0, dtype=None):
    """Uniform random fill (reference: LocalVector::SetRandomUniform;
    rocRAND on device — here jax.random, key-explicit)."""
    import jax.random as jr

    dtype = dtype or jnp.float64
    return jr.uniform(key, (n,), minval=low, maxval=high,
                      dtype=jnp.dtype(dtype))


def set_random_normal(key, n, mean=0.0, std=1.0, dtype=None):
    """Normal random fill (reference: LocalVector::SetRandomNormal)."""
    import jax.random as jr

    dtype = dtype or jnp.float64
    return mean + std * jr.normal(key, (n,), dtype=jnp.dtype(dtype))


def extract_coarse_mapping(vec, index, nc: int):
    """Renumber the coarse ids hit by boundary points into a dense local
    numbering, first-seen order (reference: LocalVector<int>::
    ExtractCoarseMapping, host_vector.cpp:1594-1632 — used to derive the
    coarse-level boundary maps during distributed AMG setup). Host-side
    numpy (setup phase). Returns (map, size)."""
    import numpy as np

    vec = np.asarray(vec)
    index = np.asarray(index, np.int64)
    coarse = vec[index]
    first = {}
    out = np.empty(len(index), np.int64)
    k = 0
    for i, c in enumerate(coarse):
        if c not in first:
            first[c] = k
            k += 1
        out[i] = first[c]
    return out, k


def extract_coarse_boundary(vec, index, nc: int):
    """Unique coarse ids hit by boundary points, first-seen order
    (reference: LocalVector<int>::ExtractCoarseBoundary,
    host_vector.cpp:1643+). Host-side numpy (setup phase)."""
    import numpy as np

    vec = np.asarray(vec)
    index = np.asarray(index, np.int64)
    coarse = vec[index]
    _, first_idx = np.unique(coarse, return_index=True)
    return coarse[np.sort(first_idx)]
