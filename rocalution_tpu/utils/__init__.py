"""Runtime utilities: logging, validation, generators, key, profiling,
device timing."""

from . import generators, key, log, profile, timing, validate  # noqa: F401
from .hoist import hoisted_jit  # noqa: F401
