"""Global configuration for rocalution_tpu.

Analog of the reference backend descriptor
(reference: src/base/backend_manager.hpp:52-111): instead of a mutable
singleton holding HIP handles/streams, we keep a small typed config of
dtype policy + verbosity. Device placement is handled by JAX shardings,
so there is no host/accelerator object duality.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import numpy as np

# rocALUTION defaults to double precision everywhere; we keep that default
# but make it a policy so solvers can run f32/bf16 and mixed-precision defect correction can bridge the gap
# (reference: src/solvers/mixed_precision.cpp).
_ENABLE_X64 = os.environ.get("ROCALUTION_TPU_X64", "1") != "0"
if _ENABLE_X64:
    jax.config.update("jax_enable_x64", True)


@dataclasses.dataclass
class Config:
    """Runtime configuration snapshot (analog of backend descriptor)."""

    # Default value dtype for matrices/vectors created without explicit dtype.
    default_dtype: np.dtype = np.dtype(np.float64)
    # Index dtype. rocALUTION: LocalType=int32 by default (src/utils/types.hpp.in).
    index_dtype: np.dtype = np.dtype(np.int32)
    # Verbosity: 0 = silent, 1 = solver start/end, 2 = per-iteration residuals
    # (reference: VERBOSE_LEVEL def.hpp:28 + Solver::Verbose).
    verbose: int = int(os.environ.get("ROCALUTION_TPU_VERBOSE", "1"))
    # DEBUG_MODE analog: run Check() validators on every op entry
    # (reference: src/utils/def.hpp:33-36).
    debug: bool = os.environ.get("ROCALUTION_TPU_DEBUG", "0") == "1"
    # Log file path for log_debug-style call tracing (reference: src/utils/log.hpp).
    log_file: Optional[str] = os.environ.get("ROCALUTION_TPU_LOG") or None


_config = Config()


def get_config() -> Config:
    return _config


def set_verbose(level: int) -> None:
    _config.verbose = int(level)


def set_debug(flag: bool) -> None:
    _config.debug = bool(flag)


def default_dtype() -> np.dtype:
    return _config.default_dtype


def set_default_dtype(dtype) -> None:
    _config.default_dtype = np.dtype(dtype)


def index_dtype() -> np.dtype:
    return _config.index_dtype

