"""Common machinery for matrix-format pytrees.

Design note (vs. reference): rocALUTION models each (backend x format) pair as
a virtual C++ class (src/base/base_matrix.hpp:79-828, one class per format per
backend). Under JAX there is exactly one backend — XLA — and device placement is
a sharding property of the arrays, so a format is simply a registered
dataclass-of-arrays (a pytree) plus free functions that operate on it. The
"host fallback" mechanism (local_matrix.cpp:132-158) becomes: every op has a
pure-XLA composition implementation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def register_format(cls):
    """Register a format dataclass as a JAX pytree.

    Array fields are children; fields annotated with ``meta=True`` in their
    dataclass metadata are static (shape/offsets/etc.).
    """
    fields = dataclasses.fields(cls)
    data_fields = [f.name for f in fields if not f.metadata.get("static", False)]
    meta_fields = [f.name for f in fields if f.metadata.get("static", False)]
    return jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )


def static_field(**kwargs):
    return dataclasses.field(metadata={"static": True}, **kwargs)


class MatrixBase:
    """Mixin providing the common query surface (GetM/GetN/GetNnz analogs)."""

    shape: Tuple[int, int]

    @property
    def nrow(self) -> int:
        return self.shape[0]

    @property
    def ncol(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype  # type: ignore[attr-defined]

    def __matmul__(self, x):
        from ..ops.spmv import spmv

        return spmv(self, x)


def as_index(a) -> jnp.ndarray:
    return jnp.asarray(a, dtype=jnp.int32)


def host_index(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int32)


# --- host-side array cache -------------------------------------------------
#
# Setup-phase code (conversions, factorizations, partitioning, the native
# C++ setup layer) works on numpy arrays. Formats built on the host keep
# numpy copies of their arrays, so setup never waits on a device read nor
# copies the operator back from the device. The cache is attached outside
# the dataclass fields, so it is invisible to jax pytree flattening.

def set_host_cache(obj, **arrays) -> None:
    object.__setattr__(obj, "_host_cache", {k: v for k, v in arrays.items()})


def get_host(obj, name: str):
    """Host numpy version of field `name`; falls back to a device read."""
    cache = getattr(obj, "_host_cache", None)
    if cache is not None and name in cache:
        return cache[name]
    return np.asarray(getattr(obj, name))


def on_device(mat):
    """`mat` with every numpy leaf uploaded, host cache kept. Setup builds
    some operators with host-resident leaves (``device=False``); a solver
    must take them as device buffers, not as constants traced into every
    program that applies them."""
    leaves = jax.tree.leaves(mat)
    if not any(isinstance(v, np.ndarray) for v in leaves):
        return mat
    out = jax.tree.map(jnp.asarray, mat)
    cache = getattr(mat, "_host_cache", None)
    if cache is not None:
        set_host_cache(out, **cache)
    return out
