"""True multi-process distributed execution:
two REAL OS processes federate via jax.distributed (gloo), each builds
only its own row block, exchanges only boundary metadata, and runs one
SPMD CG (reference: the per-rank MPI flow, parallel_manager.cpp:726-782,
docs/api-reference/multinode.rst:126-155)."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "clients", "samples", "multiprocess_cg.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cg():
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, SAMPLE, coord, str(pid), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    assert "MPROC_OK procs=2" in outs[0], outs[0]
