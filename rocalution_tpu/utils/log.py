"""Call tracing and verbose logging.

Reference parity: `log_debug` (src/utils/log.hpp:67-86 — every public call
traced to a per-run file with object/function/args) and LOG_INFO /
LOG_VERBOSE_INFO levels (:100-124).

Placement note: solver bodies are traced once and executed many times
under jit, so call tracing fires at TRACE time (one record per compiled
call-site) — which is exactly the useful granularity here; per-iteration
residuals are recorded on-device via `record_history` instead.
"""

from __future__ import annotations

import atexit
import os
import time
from typing import Optional

from ..config import get_config

_fh = None


def _file():
    global _fh
    cfg = get_config()
    if cfg.log_file is None:
        return None
    if _fh is None:
        _fh = open(cfg.log_file, "a", buffering=1)
        atexit.register(_fh.close)
    return _fh


def log_debug(obj, fn: str, *args) -> None:
    """Trace a public call (reference: log_debug)."""
    f = _file()
    if f is None:
        return
    rep = ", ".join(repr(a)[:80] for a in args)
    f.write(f"[{time.time():.6f}] [pid {os.getpid()}] "
            f"{type(obj).__name__ if obj is not None else '-'}::{fn}({rep})\n")


def log_info(*msg) -> None:
    """LOG_INFO analog: always-on informational print."""
    if get_config().verbose >= 1:
        print(*msg, flush=True)


def log_verbose(level: int, *msg) -> None:
    """LOG_VERBOSE_INFO(level) analog."""
    if get_config().verbose >= level:
        print(*msg, flush=True)
