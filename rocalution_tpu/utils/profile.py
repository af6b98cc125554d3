"""Profiling hooks (SURVEY §5 tracing row).

The reference has no dedicated profiler — it offers `rocalution_time()`
plus explicit syncs (src/utils/time_functions.*, samples/benchmark.cpp:
104-118) and the log_debug call tracer (src/utils/log.hpp:67-86). The
analog here is the XLA profiler: `with profile("dir"):` captures a
TensorBoard/xprof trace of everything dispatched inside (kernel timeline,
collective/compute overlap, HBM traffic), and `annotate("name")` labels a
region so solver phases are identifiable in the trace.

Usage:
    with rt.utils.profile.profile("/tmp/trace"):
        x, info = rt.cg(A, b, M=M, rel_tol=1e-8)
    # then: tensorboard --logdir /tmp/trace  (or xprof)
"""

from __future__ import annotations

import contextlib
import glob
import os
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def profile(logdir: str = "/tmp/rocalution_tpu_trace",
            enabled: bool = True) -> Iterator[Optional[str]]:
    """Capture a jax.profiler trace of the enclosed block.

    Yields the log directory (or None when disabled). The trace includes
    the device timeline, so halo-exchange/compute overlap in the
    distributed SpMV (parallel/ops.py) is directly visible as overlapping
    collective and fusion slices."""
    if not enabled:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Label a region in the profiler timeline (TraceAnnotation):

        with annotate("amg-vcycle"):
            e = M(r)
    """
    return jax.profiler.TraceAnnotation(name)


def latest_trace_file(logdir: str) -> Optional[str]:
    """Path of the newest .trace / .xplane.pb artifact under `logdir`."""
    pats = ("**/*.xplane.pb", "**/*.trace.json.gz", "**/*.trace")
    hits = [p for pat in pats
            for p in glob.glob(os.path.join(logdir, pat), recursive=True)]
    return max(hits, key=os.path.getmtime) if hits else None
