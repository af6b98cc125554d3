"""Distributed AMG setup tests: hierarchy built from
per-part row blocks with explicit boundary exchanges — never assembling a
level as one matrix — and a sharded iterative coarse solve (reference:
boundary-row CSR exchange + coarse-PM derivation, global_matrix.cpp:
1444-1495,4041-4311, parallel_manager.hpp:204-212)."""

import numpy as np
import pytest
import scipy.sparse as sp

import rocalution_tpu as rt
from rocalution_tpu.parallel import (dist_amg_solve_sharded,
                                     distributed_amg_setup,
                                     global_csr_from_blocks, make_mesh)
from rocalution_tpu.parallel.amg_setup import _offsets, dist_sa_level
from rocalution_tpu.solvers.krylov.cg import cg
from rocalution_tpu.utils.generators import laplacian_2d_block

NP = 4


def _blocks_from_csr(A, nparts):
    d, i, p = A.numpy_triplet()
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(p))
    offs = _offsets(nparts, A.shape[0])
    out = []
    for q in range(nparts):
        m = (rows >= offs[q]) & (rows < offs[q + 1])
        out.append((rows[m] - offs[q], i[m].astype(np.int64), d[m]))
    return out, offs


def _assemble(mats, offs, ncols):
    coo_r, coo_c, coo_d = [], [], []
    for q, m in enumerate(mats):
        c = m.tocoo()
        coo_r.append(c.row + offs[q])
        coo_c.append(c.col)
        coo_d.append(c.data)
    return sp.csr_matrix(
        (np.concatenate(coo_d), (np.concatenate(coo_r),
                                 np.concatenate(coo_c))),
        shape=(int(offs[-1]), ncols))


def test_dist_sa_level_galerkin_exact():
    """The distributed level's Ac equals R·A·P of the FULL operator —
    the boundary-row exchanges carry every cross-part coupling."""
    A = rt.laplacian_2d(16)
    S = sp.csr_matrix(tuple(A.numpy_triplet()[i] for i in (0, 1, 2)),
                      shape=A.shape)
    blocks, offs = _blocks_from_csr(A, NP)
    mats = [sp.csr_matrix((b[2], (b[0], b[1])),
                          shape=(int(offs[q + 1] - offs[q]), A.shape[0]))
            for q, b in enumerate(blocks)]
    P_m, R_m, Ac_m, coffs = dist_sa_level(mats, offs, strategy="greedy")
    NC = int(coffs[-1])
    Pg = _assemble(P_m, offs, NC)
    Rg = _assemble(R_m, coffs, A.shape[0])
    Acg = _assemble(Ac_m, coffs, NC)
    # R is exactly P^T
    assert (Rg != Pg.T.tocsr()).nnz == 0
    # Galerkin triple product of the FULL fine operator
    ref = (Pg.T @ S @ Pg).tocsr()
    diff = Acg - ref
    assert np.abs(diff.data).max() if diff.nnz else 0.0 < 1e-12
    assert NC < A.shape[0]


def test_dist_amg_setup_and_solve_from_blocks():
    """End-to-end: per-part generated blocks (global matrix NEVER formed)
    -> distributed hierarchy -> sharded CG+AMG solve to 1e-8."""
    n = 24
    N = n * n
    offs = _offsets(NP, N)
    blocks = [laplacian_2d_block(n, int(offs[q]), int(offs[q + 1]))
              for q in range(NP)]
    dl = distributed_amg_setup(blocks, (N, N), coarse_size=60,
                               strategy="greedy")
    assert len(dl.As) >= 2
    assert len(dl.Ps) == len(dl.As) - 1
    # rhs for x_true = 1 computed from the blocks alone
    b = np.zeros(N)
    for q, (r, c, d) in enumerate(blocks):
        np.add.at(b, r + int(offs[q]), d)
    x, info = dist_amg_solve_sharded(cg, dl, b, mesh=make_mesh(NP),
                                     rel_tol=1e-8, max_iter=100)
    assert int(info.status) in (1, 2)
    err = np.linalg.norm(np.asarray(x) - 1.0)
    assert err < 1e-5, err
    # AMG actually helps: far fewer iterations than unpreconditioned CG
    A = rt.laplacian_2d(n)
    _, info_plain = rt.cg(A, b, rel_tol=1e-8, max_iter=500)
    assert int(info.iterations) < int(info_plain.iterations) / 3


def test_dist_amg_matches_single_part():
    """nparts=1 distributed setup reproduces the same coarsening the
    serial decoupled algorithm gives (sanity anchor)."""
    A = rt.laplacian_2d(12)
    blocks, offs = _blocks_from_csr(A, 1)
    dl = distributed_amg_setup(blocks, A.shape, coarse_size=30,
                               strategy="greedy")
    b = np.asarray(rt.spmv(A, np.ones(A.shape[0])))
    x, info = dist_amg_solve_sharded(cg, dl, b, mesh=make_mesh(1),
                                     rel_tol=1e-8, max_iter=100)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-5


def test_dist_rs_level_galerkin_exact():
    """Distributed RS level: decoupled C/F + direct
    interpolation per part; the exchanged Galerkin product must still be
    the exact R·A·P of the FULL fine operator, with R = P^T."""
    from rocalution_tpu.parallel.amg_setup import dist_rs_level

    A = rt.laplacian_2d(16)
    S = sp.csr_matrix(tuple(A.numpy_triplet()[i] for i in (0, 1, 2)),
                      shape=A.shape)
    blocks, offs = _blocks_from_csr(A, NP)
    mats = [sp.csr_matrix((b[2], (b[0], b[1])),
                          shape=(int(offs[q + 1] - offs[q]), A.shape[0]))
            for q, b in enumerate(blocks)]
    for interp in ("direct", "extpi"):
        P_m, R_m, Ac_m, coffs = dist_rs_level(mats, offs,
                                              interpolation=interp)
        NC = int(coffs[-1])
        Pg = _assemble(P_m, offs, NC)
        Rg = _assemble(R_m, coffs, A.shape[0])
        Acg = _assemble(Ac_m, coffs, NC)
        assert (Rg != Pg.T.tocsr()).nnz == 0
        ref = (Pg.T @ S @ Pg).tocsr()
        diff = (Acg - ref)
        mx = np.abs(diff.data).max() if diff.nnz else 0.0
        assert mx < 1e-12, (interp, mx)
        assert 0 < NC < A.shape[0]


def test_dist_rs_setup_and_solve():
    """End-to-end distributed RS-AMG: blocks -> hierarchy -> sharded
    CG+AMG solve (reference: global RS build, global_matrix.cpp:
    1444-1495 at global scope)."""
    n = 24
    N = n * n
    offs = _offsets(NP, N)
    blocks = [laplacian_2d_block(n, int(offs[q]), int(offs[q + 1]))
              for q in range(NP)]
    dl = distributed_amg_setup(blocks, (N, N), kind="rs", coarse_size=60)
    assert len(dl.As) >= 2
    b = np.zeros(N)
    for q, (r, c, d) in enumerate(blocks):
        np.add.at(b, r + int(offs[q]), d)
    x, info = dist_amg_solve_sharded(cg, dl, b, mesh=make_mesh(NP),
                                     rel_tol=1e-8, max_iter=120)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-5
    _, info_plain = rt.cg(rt.laplacian_2d(n), b, rel_tol=1e-8, max_iter=500)
    assert int(info.iterations) < int(info_plain.iterations) / 2


def test_dist_rs_single_part_matches_serial():
    """nparts=1 distributed RS = the serial rs_level exactly (no
    decoupling at one part): identical coarse size and iterations."""
    from rocalution_tpu.parallel.amg_setup import dist_rs_level
    from rocalution_tpu.solvers.multigrid.rs import rs_level

    A = rt.laplacian_2d(12)
    S = sp.csr_matrix(tuple(A.numpy_triplet()[i] for i in (0, 1, 2)),
                      shape=A.shape)
    blocks, offs = _blocks_from_csr(A, 1)
    mats = [sp.csr_matrix((blocks[0][2], (blocks[0][0], blocks[0][1])),
                          shape=A.shape)]
    P_m, R_m, Ac_m, coffs = dist_rs_level(mats, offs, seed=0)
    Ps, Rs, Acs = rs_level(A, seed=0)
    assert int(coffs[-1]) == Ps.shape[1]
    Pg = _assemble(P_m, offs, int(coffs[-1]))
    d, i, p = Ps.numpy_triplet()
    Pser = sp.csr_matrix((d, i, p), shape=Ps.shape)
    diff = Pg - Pser
    mx = np.abs(diff.data).max() if diff.nnz else 0.0
    assert mx < 1e-12, mx


def test_global_transpose_and_triple_product():
    """Standalone distributed ops (reference: GlobalMatrix::Transpose /
    TripleMatrixProduct, global_matrix.hpp:212-219) — exact vs the
    assembled serial results, including a rectangular operand."""
    from rocalution_tpu.parallel import (distribute_csr, global_transpose,
                                         global_triple_product)
    from rocalution_tpu.parallel.matops import _block_cache

    A = rt.laplacian_2d(12)
    d, i, p = A.numpy_triplet()
    S = sp.csr_matrix((d, i, p), shape=A.shape)
    Ag = distribute_csr(A, NP)
    Tg = global_transpose(Ag)
    mats, offs = _block_cache(Tg)
    T_assembled = _assemble(mats, offs, A.shape[0])
    assert (T_assembled != S.T.tocsr()).nnz == 0

    # rectangular P (n x nc): R A P with R = P^T
    P_m, R_m, Ac_m, coffs = dist_sa_level(
        [m for m in _block_cache(Ag)[0]], offs, strategy="greedy")
    NC = int(coffs[-1])
    Pg = global_csr_from_blocks(
        [( (c := m.tocoo()).row, c.col, c.data) for m in P_m],
        (A.shape[0], NC))
    Rg = global_transpose(Pg)
    mats_r, offs_r = _block_cache(Rg)
    Rg_assembled = _assemble(mats_r, offs_r, A.shape[0])
    Pg_assembled = _assemble(*_block_cache(Pg), NC)
    assert (Rg_assembled != Pg_assembled.T.tocsr()).nnz == 0

    Acg = global_triple_product(Rg, Ag, Pg)
    Ac_assembled = _assemble(*_block_cache(Acg), NC)
    ref = (Pg_assembled.T @ S @ Pg_assembled).tocsr()
    diff = Ac_assembled - ref
    mx = np.abs(diff.data).max() if diff.nnz else 0.0
    assert mx < 1e-12, mx


@pytest.mark.parametrize("cycle", ["W", "F", "K"])
def test_dist_cycles(cycle):
    """Distributed W/F/K cycles (the reference runs every cycle at global
    scope, base_multigrid.cpp:720-981 instantiated for GlobalMatrix).
    Outer FCG tolerates the K-cycle's
    variable preconditioning."""
    from rocalution_tpu.solvers.krylov.fcg import fcg

    n = 24
    N = n * n
    offs = _offsets(NP, N)
    blocks = [laplacian_2d_block(n, int(offs[q]), int(offs[q + 1]))
              for q in range(NP)]
    dl = distributed_amg_setup(blocks, (N, N), coarse_size=60,
                               strategy="greedy")
    b = np.zeros(N)
    for q, (r, c, d) in enumerate(blocks):
        np.add.at(b, r + int(offs[q]), d)
    x, info = dist_amg_solve_sharded(fcg, dl, b, mesh=make_mesh(NP),
                                     cycle=cycle, rel_tol=1e-8,
                                     max_iter=100)
    assert int(info.status) in (1, 2), (cycle, int(info.status))
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-5
    # stronger cycles must not be weaker than V
    _, info_v = dist_amg_solve_sharded(fcg, dl, b, mesh=make_mesh(NP),
                                       cycle="V", rel_tol=1e-8,
                                       max_iter=100)
    assert int(info.iterations) <= int(info_v.iterations) + 2


def test_dist_pairwise_setup_and_solve():
    """Distributed pairwise AMG (completes the global-scope AMG family;
    reference PairwiseAMG for GlobalMatrix): Galerkin exactness is shared
    machinery, so the end-to-end sharded solve is the check."""
    n = 24
    N = n * n
    offs = _offsets(NP, N)
    blocks = [laplacian_2d_block(n, int(offs[q]), int(offs[q + 1]))
              for q in range(NP)]
    dl = distributed_amg_setup(blocks, (N, N), kind="pairwise",
                               coarse_size=60)
    assert len(dl.As) >= 2
    b = np.zeros(N)
    for q, (r, c, d) in enumerate(blocks):
        np.add.at(b, r + int(offs[q]), d)
    x, info = dist_amg_solve_sharded(cg, dl, b, mesh=make_mesh(NP),
                                     rel_tol=1e-8, max_iter=200)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-5


def test_dist_ua_level_galerkin_exact():
    """Distributed UA level: tentative-only P per
    part; the exchanged Galerkin product must still be the exact R·A·P
    of the FULL fine operator (reference: global UAAMG,
    unsmoothed_amg.cpp GlobalMatrix instantiations)."""
    from rocalution_tpu.parallel.amg_setup import dist_ua_level

    A = rt.laplacian_2d(16)
    S = sp.csr_matrix(tuple(A.numpy_triplet()[i] for i in (0, 1, 2)),
                      shape=A.shape)
    blocks, offs = _blocks_from_csr(A, NP)
    mats = [sp.csr_matrix((b[2], (b[0], b[1])),
                          shape=(int(offs[q + 1] - offs[q]), A.shape[0]))
            for q, b in enumerate(blocks)]
    P_m, R_m, Ac_m, coffs = dist_ua_level(mats, offs, strategy="greedy")
    NC = int(coffs[-1])
    Pg = _assemble(P_m, offs, NC)
    Rg = _assemble(R_m, coffs, A.shape[0])
    Acg = _assemble(Ac_m, coffs, NC)
    assert (Rg != Pg.T.tocsr()).nnz == 0
    # tentative P: exactly one unit entry per fine row
    assert Pg.nnz == A.shape[0] and np.all(Pg.data == 1.0)
    ref = (Pg.T @ S @ Pg).tocsr()
    diff = Acg - ref
    mx = np.abs(diff.data).max() if diff.nnz else 0.0
    assert mx < 1e-12, mx
    assert 0 < NC < A.shape[0]


def test_dist_ua_setup_and_solve():
    """End-to-end distributed UA-AMG via kind="ua"."""
    n = 24
    N = n * n
    offs = _offsets(NP, N)
    blocks = [laplacian_2d_block(n, int(offs[q]), int(offs[q + 1]))
              for q in range(NP)]
    dl = distributed_amg_setup(blocks, (N, N), kind="ua", coarse_size=60,
                               strategy="greedy")
    assert len(dl.As) >= 2
    b = np.zeros(N)
    for q, (r, c, d) in enumerate(blocks):
        np.add.at(b, r + int(offs[q]), d)
    x, info = dist_amg_solve_sharded(cg, dl, b, mesh=make_mesh(NP),
                                     rel_tol=1e-8, max_iter=200)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-5


def test_dist_geometric_mg_from_blocks():
    """Distributed geometric MultiGrid with USER-SUPPLIED per-level
    blocks (reference: MultiGrid solver for GlobalMatrix —
    SetOperator/SetRestrictOperator/SetProlongOperator per level,
    multigrid.cpp): a serial-built hierarchy split into row blocks must
    drive the sharded cycle to the same answer."""
    from rocalution_tpu.parallel import dist_levels_from_blocks
    from rocalution_tpu.solvers.multigrid import amg_hierarchy

    n = 24
    A = rt.laplacian_2d(n)
    h = amg_hierarchy(A, coarse_size=60, strategy="greedy")
    assert len(h.levels) >= 2

    def blocks_of(M, nparts):
        b, _ = _blocks_from_csr(M, nparts)
        return b

    sizes = [lv.A.shape[0] for lv in h.levels]
    A_blocks = [blocks_of(lv.A, NP) for lv in h.levels]
    P_blocks = [blocks_of(lv.P, NP) for lv in h.levels[:-1]]
    R_blocks = [blocks_of(lv.R, NP) for lv in h.levels[:-1]]
    dl = dist_levels_from_blocks(A_blocks, P_blocks, R_blocks, sizes)
    assert len(dl.As) == len(sizes)
    b = np.asarray(rt.spmv(A, np.ones(A.shape[0])))
    x, info = dist_amg_solve_sharded(cg, dl, b, mesh=make_mesh(NP),
                                     rel_tol=1e-8, max_iter=100)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - 1.0) < 1e-5
