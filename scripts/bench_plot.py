#!/usr/bin/env python3
"""Tabulate / plot bench_cli JSONL results.

Reference parity: scripts/rocalution-bench-plot.py +
rocalution-bench-compare.py (gnuplot analyze/solve/iter charts). Here the
primary output is a markdown table grouped by case (terminal-first — the
machines this targets are headless); `--png FILE` additionally renders a
grouped bar chart when matplotlib is importable.

Usage:
  python scripts/bench_plot.py results.jsonl [more.jsonl ...] [--png out.png]
  python scripts/bench_plot.py a.jsonl --compare b.jsonl   # ratio table
"""

from __future__ import annotations

import argparse
import json
import sys


def load(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            if "solver" in r:
                rows.append(r)
    return rows


def case_key(r):
    return (r.get("solver"), r.get("precond"), r.get("format"),
            r.get("matrix", r.get("size")))


def fmt_case(k):
    return f"{k[0]}+{k[1]}/{k[2]} {k[3]}"


def table(rows, out=sys.stdout):
    hdr = ("case", "conv", "iter", "analyze_s", "solve_s", "nrmmax_err")
    out.write("| " + " | ".join(hdr) + " |\n")
    out.write("|" + "|".join("---" for _ in hdr) + "|\n")
    for r in rows:
        out.write("| {} | {} | {} | {} | {} | {} |\n".format(
            fmt_case(case_key(r)),
            "yes" if r.get("convergence") else "NO",
            r.get("iter", "-"),
            r.get("time_analyze_s", "-"),
            r.get("time_solve_s", "-"),
            ("%.2e" % r["nrmmax_err"]) if "nrmmax_err" in r else "-",
        ))


def compare(rows_a, rows_b, out=sys.stdout):
    """Per-case NEW/OLD ratio of analyze/solve times + iteration delta
    (the bench-compare ratio columns)."""
    b_by = {case_key(r): r for r in rows_b}
    hdr = ("case", "solve_ratio", "analyze_ratio", "iter_delta")
    out.write("| " + " | ".join(hdr) + " |\n")
    out.write("|" + "|".join("---" for _ in hdr) + "|\n")
    for r in rows_a:
        o = b_by.get(case_key(r))
        if o is None:
            continue

        def ratio(k):
            num, den = r.get(k), o.get(k)
            if not num or not den:
                return "-"
            return "%.2fx" % (num / den)

        it = ("%+d" % (r["iter"] - o["iter"])
              if "iter" in r and "iter" in o else "-")
        out.write("| {} | {} | {} | {} |\n".format(
            fmt_case(case_key(r)), ratio("time_solve_s"),
            ratio("time_analyze_s"), it))


def png(rows, path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        print("matplotlib unavailable; skipping --png", file=sys.stderr)
        return
    import numpy as np

    labels = [fmt_case(case_key(r)) for r in rows]
    solve = [r.get("time_solve_s", 0.0) for r in rows]
    analyze = [r.get("time_analyze_s", 0.0) for r in rows]
    x = np.arange(len(rows))
    fig, ax = plt.subplots(figsize=(max(6, len(rows) * 0.9), 4))
    ax.bar(x - 0.2, analyze, 0.4, label="analyze")
    ax.bar(x + 0.2, solve, 0.4, label="solve")
    ax.set_xticks(x)
    ax.set_xticklabels(labels, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("seconds")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    print(f"wrote {path}", file=sys.stderr)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("files", nargs="+", help="bench_cli --out JSONL files")
    p.add_argument("--compare", default=None,
                   help="baseline JSONL: print NEW/OLD ratio table")
    p.add_argument("--png", default=None, help="also render a bar chart")
    args = p.parse_args()

    rows = [r for f in args.files for r in load(f)]
    if not rows:
        print("no result rows found", file=sys.stderr)
        return 1
    if args.compare:
        compare(rows, load(args.compare))
    else:
        table(rows)
    if args.png:
        png(rows, args.png)
    return 0


if __name__ == "__main__":
    sys.exit(main())
