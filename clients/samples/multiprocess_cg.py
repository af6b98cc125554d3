"""True multi-process distributed CG — the MPI-sample analog.

Reference parity: clients/samples/cg_mpi.cpp — every rank builds ITS OWN
matrix part + ParallelManager from local data, then all ranks run the
same solver (docs/api-reference/multinode.rst:126-155). Here each
PROCESS builds its row block with a per-rank generator, exchanges only
boundary metadata (parallel/multiproc.py), and the solve is one SPMD jit
program across all processes.

Launch one instance per process (CPU/gloo shown). On GPUs, drop the
platform override and start each process with its own
``CUDA_VISIBLE_DEVICES`` — a JAX process reserves most of the memory of
every card it sees, so two processes must not share one:

    python clients/samples/multiprocess_cg.py localhost:9876 0 2 &
    python clients/samples/multiprocess_cg.py localhost:9876 1 2
"""

import sys

import numpy as np


def _orchestrate():
    """No-args mode: launch a 2-process run of this sample (smoke test)."""
    import os
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("localhost", 0))
    coord = f"localhost:{s.getsockname()[1]}"
    s.close()
    here = os.path.abspath(__file__)
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, here, coord, str(p), "2"],
                              env=env) for p in (0, 1)]
    rcs = [p.wait(timeout=240) for p in procs]
    assert rcs == [0, 0], rcs
    print("status=2 (2-process orchestration OK)")


def main():
    if len(sys.argv) < 4:
        return _orchestrate()
    coord, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import jax

    jax.config.update("jax_platforms", "cpu")
    import rocalution_tpu as rt
    from rocalution_tpu.parallel.multiproc import (dist_solve_spmd,
                                                   global_csr_multiproc)

    rt.backend.init(coordinator_address=coord, num_processes=nproc,
                    process_id=pid)
    assert jax.process_count() == nproc

    n = 48                       # 48x48 grid = 2304 unknowns
    N = n * n
    nl = -(-N // nproc)
    lo, hi = pid * nl, min(N, (pid + 1) * nl)
    from rocalution_tpu.utils.generators import laplacian_2d_block

    block = laplacian_2d_block(n, lo, hi)

    Ag = global_csr_multiproc(block, (N, N))

    # rhs for x_true = 1 and the Jacobi diagonal — from LOCAL data only
    r, c, d = block
    b_local = np.zeros(Ag.n_local)
    np.add.at(b_local, r, d)
    diag = np.ones(Ag.n_local)
    own = c - lo == r
    np.add.at(diag, r[own], d[own] - 1.0)
    x_true = np.zeros(Ag.n_local)
    x_true[: hi - lo] = 1.0

    from rocalution_tpu.solvers.krylov.cg import cg

    x_own, info, err = dist_solve_spmd(
        cg, Ag, b_local, inv_diag_local=1.0 / diag, x_true_local=x_true,
        rel_tol=1e-10, max_iter=500)
    if pid == 0:
        print(f"MPROC_OK procs={nproc} iters={int(info.iterations)} "
              f"status={int(info.status)} err={err:.3e}", flush=True)
    assert int(info.status) in (1, 2) and err < 1e-6


if __name__ == "__main__":
    main()
