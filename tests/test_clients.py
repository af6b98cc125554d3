"""Client-layer tests: bench CLI contract + matrix key (reference: clients/
benchmarks driver + key.cpp sample)."""

import json
import os
import subprocess
import sys

import pytest

import numpy as np

import rocalution_tpu as rt
from rocalution_tpu.utils.key import matrix_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_cli_json(tmp_path):
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", ROOT), "PYTHONPATH": ROOT}
    out = subprocess.run(
        [sys.executable, "-m", "rocalution_tpu.bench_cli", "--solver", "cg",
         "--precond", "jacobi", "--format", "DIA", "--size", "16",
         "--tol", "1e-8"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["convergence"] is True
    assert res["iter"] > 0
    assert res["nrmmax_err"] < 1e-5
    for k in ("time_import_s", "time_analyze_s", "time_solve_s"):
        assert k in res


def test_bench_cli_amg(tmp_path):
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", ROOT), "PYTHONPATH": ROOT}
    out = subprocess.run(
        [sys.executable, "-m", "rocalution_tpu.bench_cli", "--solver",
         "saamg", "--size", "24"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["convergence"] is True


def test_matrix_key():
    A, B, C = rt.laplacian_2d(12), rt.laplacian_2d(12), rt.laplacian_2d(13)
    assert matrix_key(A) == matrix_key(B)
    assert matrix_key(A) != matrix_key(C)
    # value-only change flips only the value component
    d, i, p = A.numpy_triplet()
    D = rt.CSR.from_arrays(d * 2.0, i, p, A.shape)
    ka, kd = matrix_key(A), matrix_key(D)
    assert ka[0] == kd[0] and ka[1] == kd[1] and ka[2] != kd[2]


def _all_samples():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = os.path.join(root, "clients", "samples")
    return sorted(f[:-3] for f in os.listdir(d) if f.endswith(".py"))


# samples that demonstrate something other than a convergent solve —
# success = clean exit + their own printed check
_NO_CONVERGENCE_CHECK = {
    "key", "simple_spmv", "power_method", "benchmark", "benchmark_dist",
    "async_transfer", "cmk", "global_io",
    # weak-scaling demos report t/iter + efficiency, not a solve status
    "laplace_2d_weak_scaling", "laplace_3d_weak_scaling",
}


@pytest.mark.parametrize("sample", _all_samples())
def test_sample_runs(sample):
    """EVERY sample program executes and (where it solves) reports
    convergence — the reference treats samples as smoke tests
    (docs/contribution/clients.rst); r3 weakness 6 was 8/38 coverage."""
    import os
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "clients", "samples", f"{sample}.py")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu')\n"
        f"import runpy; runpy.run_path({path!r}, run_name='__main__')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=420,
        env={"PATH": "/usr/bin:/bin", "HOME": os.environ.get("HOME", root),
             "PYTHONPATH": root,
             "POISSON_N": "24",        # CI-size for the scale demo
             "XLA_FLAGS": "--xla_force_host_platform_device_count=8"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    if sample in _NO_CONVERGENCE_CHECK:
        return
    import re

    errs = re.findall(r"err(?:or)?[=:]\s*([0-9.e+-]+)", out.stdout)
    converged = ("status=1" in out.stdout or "status=2" in out.stdout
                 or "converged" in out.stdout.lower()
                 or (errs and float(errs[-1]) < 1e-3))
    assert converged, out.stdout


def test_bench_cli_sweep_and_tools(tmp_path):
    """Sweep expander (rocalution_bench_cmdlines.hpp:100 analog): comma
    lists expand to the cartesian product, one JSON line per case plus a
    summary; bench_execute/bench_plot consume the JSONL."""
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", ROOT), "PYTHONPATH": ROOT}
    out_file = str(tmp_path / "sweep.jsonl")
    out = subprocess.run(
        [sys.executable, "-m", "rocalution_tpu.bench_cli", "--solver",
         "cg,bicgstab", "--precond", "none,jacobi", "--size", "12,16",
         "--out", out_file],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(s) for s in out.stdout.strip().splitlines()]
    summary = lines[-1]["sweep_summary"]
    assert summary["cases"] == 8 and summary["converged"] == 8
    assert sum(1 for r in lines[:-1] if r.get("convergence")) == 8
    # plot tool renders a table from the JSONL
    out2 = subprocess.run(
        [sys.executable, "scripts/bench_plot.py", out_file],
        capture_output=True, text=True, env=env, timeout=60,
        cwd=ROOT,
    )
    assert out2.returncode == 0 and out2.stdout.count("\n") >= 9
    # compare tool: self-comparison gives 1.00x ratios
    out3 = subprocess.run(
        [sys.executable, "scripts/bench_plot.py", out_file,
         "--compare", out_file],
        capture_output=True, text=True, env=env, timeout=60,
        cwd=ROOT,
    )
    assert out3.returncode == 0 and "1.00x" in out3.stdout
