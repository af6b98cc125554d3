#!/usr/bin/env python3
"""Quantify halo-exchange/compute overlap from a jax.profiler trace.

The reference's defining distributed-perf feature is running the interior
SpMV while the ghost exchange is in flight (3 HIP streams,
global_matrix.cpp:924-1009). The JAX analog: XLA's latency-hiding
scheduler overlaps the `ppermute`/`all-gather` collectives issued by
parallel/ops.shard_spmv with the interior compute fusions. This tool reads
a trace captured with rocalution_tpu.utils.profile.profile() and reports,
per device timeline, how much collective time is covered by concurrent
compute.

Usage: python scripts/trace_overlap.py /tmp/rt_trace [substr...]
"""

from __future__ import annotations

import gzip
import json
import sys

COLLECTIVE_MARKS = ("collective-permute", "all-gather", "all-reduce",
                    "reduce-scatter", "ppermute", "collective")
COMPUTE_MARKS = ("fusion", "dot", "convolution", "custom-call", "scan",
                 "while", "loop")


def load_events(path: str):
    from rocalution_tpu.utils.profile import latest_trace_file

    f = latest_trace_file(path) if not path.endswith((".gz", ".json")) else path
    if f is None:
        raise SystemExit(f"no trace artifact under {path}")
    opener = gzip.open if f.endswith(".gz") else open
    with opener(f, "rt") as fh:
        doc = json.load(fh)
    return f, doc.get("traceEvents", [])


def union_len(ivals):
    ivals = sorted(ivals)
    total, end = 0.0, -1.0
    for a, b in ivals:
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def overlap_len(coll, comp):
    """Total time where a collective interval intersects any compute."""
    comp = sorted(comp)
    total = 0.0
    j = 0
    for a, b in sorted(coll):
        while j < len(comp) and comp[j][1] <= a:
            j += 1
        k = j
        covered = a
        while k < len(comp) and comp[k][0] < b:
            lo = max(covered, comp[k][0])
            hi = min(b, comp[k][1])
            if hi > lo:          # count each slice once (nested events)
                total += hi - lo
                covered = hi
            k += 1
    return total


def main(argv):
    path = argv[1] if len(argv) > 1 else "/tmp/rocalution_tpu_trace"
    f, events = load_events(path)
    per_track: dict = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        name = str(e.get("name", "")).lower()
        tid = (e.get("pid"), e.get("tid"))
        a = float(e["ts"])
        b = a + float(e["dur"])
        kind = None
        if any(m in name for m in COLLECTIVE_MARKS):
            kind = "coll"
        elif any(m in name for m in COMPUTE_MARKS):
            kind = "comp"
        if kind:
            per_track.setdefault(tid, {"coll": [], "comp": []})[kind].append(
                (a, b))

    print(f"trace: {f}")
    tot_c = tot_o = 0.0
    for tid, d in sorted(per_track.items()):
        if not d["coll"]:
            continue
        # compute intervals from EVERY track (collectives overlap compute
        # scheduled on other queues of the same device)
        comp_all = [iv for dd in per_track.values() for iv in dd["comp"]]
        c = union_len(d["coll"])
        o = overlap_len(d["coll"], comp_all)
        tot_c += c
        tot_o += o
        print(f"  track {tid}: collective {c/1e3:.2f} ms, "
              f"overlapped {o/1e3:.2f} ms ({100*o/max(c,1e-9):.0f}%)")
    if tot_c:
        print(f"TOTAL: {100*tot_o/tot_c:.0f}% of collective time overlapped "
              "with compute")
    else:
        print("no collective events found (serial trace?)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
