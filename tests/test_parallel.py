"""Distributed-path tests on the 8-device virtual CPU mesh — automated
multi-rank coverage (improves on the reference, SURVEY.md §4 gap)."""

import jax
import numpy as np
import pytest

import rocalution_tpu as rt
from rocalution_tpu.parallel import (block_jacobi_diag, dist_solve,
                                     distribute_csr, distribute_vector,
                                     gather_vector, make_mesh, shard_spmv)
from rocalution_tpu.solvers.krylov.cg import cg

NP = 4


@pytest.fixture(scope="module")
def problem():
    A = rt.laplacian_2d(12)  # 144 unknowns, not divisible by 4? 144/4=36 ok
    x_true = np.ones(A.shape[0])
    b = np.asarray(rt.spmv(A, x_true))
    return A, b, x_true


def test_partition_roundtrip_spmv(problem, rng):
    A, b, _ = problem
    Ag = distribute_csr(A, NP)
    assert Ag.nnz == A.nnz
    x = rng.standard_normal(A.shape[0])
    xp = distribute_vector(x, NP, Ag.n_local)
    mesh = make_mesh(NP)
    from jax.sharding import PartitionSpec as P

    fn = jax.shard_map(
        lambda Ash, xs: shard_spmv(Ash, xs[0], "p")[None],
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P("p"), Ag), P("p")),
        out_specs=P("p"),
    )
    yp = fn(Ag, xp)
    y = np.asarray(gather_vector(yp, Ag.n_global))
    np.testing.assert_allclose(y, np.asarray(rt.spmv(A, x)), rtol=1e-12)


def test_dist_cg_matches_serial(problem):
    A, b, x_true = problem
    Ag = distribute_csr(A, NP)
    x, info = dist_solve(cg, Ag, b, rel_tol=1e-10, max_iter=500)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-6
    # iteration count parity with serial CG
    _, sinfo = rt.cg(A, b, rel_tol=1e-10, max_iter=500)
    assert abs(int(info.iterations) - int(sinfo.iterations)) <= 1


def test_dist_cg_jacobi(problem):
    A, b, x_true = problem
    Ag = distribute_csr(A, NP)
    M = block_jacobi_diag(Ag)
    x, info = dist_solve(cg, Ag, b, M=M, rel_tol=1e-10, max_iter=500)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-6


def test_uneven_partition(rng):
    # n=100 over 8 parts -> padding rows exercised
    A = rt.utils.generators.random_spd(100, density=0.06, seed=3)
    x_true = rng.standard_normal(100)
    b = np.asarray(rt.spmv(A, x_true))
    Ag = distribute_csr(A, 8)
    x, info = dist_solve(cg, Ag, b, rel_tol=1e-12, max_iter=2000)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-5 * max(
        1, np.linalg.norm(x_true)
    )


@pytest.mark.parametrize(
    "solver",
    [rt.cg, rt.cr, rt.fcg, rt.bicgstab, rt.bicgstabl, rt.gmres, rt.fgmres,
     rt.idr, rt.qmrcgstab],
)
def test_dist_solver_family(problem, solver):
    """Every Krylov solver serves the Global instantiation through the same
    code path (reference: per-solver Global template instantiations)."""
    A, b, x_true = problem
    Ag = distribute_csr(A, NP)
    M = block_jacobi_diag(Ag)
    x, info = dist_solve(solver, Ag, b, M=M, rel_tol=1e-9, max_iter=2000)
    assert int(info.status) in (1, 2), solver.__name__
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-5, solver.__name__


def test_neighbor_sparse_mode(problem, rng):
    """ppermute neighbor exchange must match the all_gather fallback and be
    selected for banded partitions (the reference's neighbor-sparse
    property)."""
    A, b, x_true = problem
    Ag_pp = distribute_csr(A, NP)
    assert Ag_pp.mode == "ppermute" and len(Ag_pp.shifts) <= 2, (
        Ag_pp.mode, Ag_pp.shifts)
    Ag_ag = distribute_csr(A, NP, max_neighbor_shifts=0)
    assert Ag_ag.mode == "allgather"
    x = rng.standard_normal(A.shape[0])
    xp = distribute_vector(x, NP, Ag_pp.n_local)
    mesh = make_mesh(NP)
    from jax.sharding import PartitionSpec as P

    def run(Ag):
        fn = jax.shard_map(
            lambda Ash, xs: shard_spmv(Ash, xs[0], "p")[None],
            mesh=mesh,
            in_specs=(jax.tree.map(lambda _: P("p"), Ag), P("p")),
            out_specs=P("p"),
        )
        return np.asarray(gather_vector(fn(Ag, xp), Ag.n_global))

    y_ref = np.asarray(rt.spmv(A, x))
    np.testing.assert_allclose(run(Ag_pp), y_ref, rtol=1e-12)
    np.testing.assert_allclose(run(Ag_ag), y_ref, rtol=1e-12)


def test_neighbor_sparse_dist_solve(problem):
    A, b, x_true = problem
    Ag = distribute_csr(A, NP)
    assert Ag.mode == "ppermute"
    x, info = dist_solve(rt.cg, Ag, b, M=block_jacobi_diag(Ag),
                         rel_tol=1e-10, max_iter=500)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-6


@pytest.mark.parametrize("kind", ["sa", "ua", "rs"])
def test_dist_amg(problem, kind):
    """Distributed AMG-preconditioned CG: converges and matches the serial
    hierarchy iterate-for-iterate (same hierarchy, sharded execution)."""
    from rocalution_tpu.parallel import dist_amg_solve
    from rocalution_tpu.solvers.multigrid import amg_precond

    A, b, x_true = problem
    x, info = dist_amg_solve(rt.cg, A, b, NP, kind=kind,
                             amg_kwargs={"coarse_size": 40},
                             rel_tol=1e-10, max_iter=200)
    assert int(info.status) in (1, 2), kind
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-6, kind
    _, sinfo = rt.cg(A, b, M=amg_precond(A, kind, coarse_size=40),
                     rel_tol=1e-10, max_iter=200)
    assert abs(int(info.iterations) - int(sinfo.iterations)) <= 2, (
        kind, int(info.iterations), int(sinfo.iterations))


def test_dist_rect_spmv(problem, rng):
    """Rectangular distributed operators (AMG transfers)."""
    from jax.sharding import PartitionSpec as P

    A, _, _ = problem
    from rocalution_tpu.solvers.multigrid.aggregation import sa_level

    Pm, Rm, Ac = sa_level(A)
    Pg = distribute_csr(Pm, NP)
    xc = rng.standard_normal(Pm.shape[1])
    xcp = distribute_vector(xc, NP, Pg.n_local_col)
    mesh = make_mesh(NP)
    fn = jax.shard_map(
        lambda Ash, xs: shard_spmv(Ash, xs[0], "p")[None],
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P("p"), Pg), P("p")),
        out_specs=P("p"),
    )
    y = np.asarray(gather_vector(fn(Pg, xcp), Pg.n_global))
    np.testing.assert_allclose(y, np.asarray(rt.spmv(Pm, xc)), rtol=1e-10)


@pytest.mark.parametrize("kind,solver_name", [
    ("spai", "cg"), ("fsai", "cg"), ("ilu0", "fgmres"), ("ilut", "fgmres"),
])
def test_block_jacobi_local_precond(kind, solver_name):
    """BlockJacobi with a LOCAL sub-preconditioner per diagonal block
    (reference: preconditioner_blockjacobi.hpp, as used by fgmres_mpi/
    idr_mpi/fcg_mpi/qmrcgstab_mpi): converges and beats no-precond."""
    from rocalution_tpu.parallel import (block_jacobi_precond, dist_solve,
                                         distribute_csr, make_mesh)

    A = rt.laplacian_2d(32)
    b = np.asarray(rt.spmv(A, np.ones(A.shape[0])))
    Ag = distribute_csr(A, 8)
    mesh = make_mesh(8)
    solver = getattr(rt, solver_name)
    _, i0 = dist_solve(solver, Ag, b, mesh=mesh, rel_tol=1e-8, max_iter=2000)
    M = block_jacobi_precond(Ag, kind)
    x, info = dist_solve(solver, Ag, b, M=M, mesh=mesh, rel_tol=1e-8,
                         max_iter=2000)
    err = np.linalg.norm(np.asarray(x) - 1.0)
    assert err < 1e-5, (kind, err)
    assert int(info.iterations) <= int(i0.iterations), (kind,)


def _spread(tree):
    """The fewest distinct devices that any array leaf of `tree` sits on."""
    return min(len({s.device for s in leaf.addressable_shards})
               for leaf in jax.tree.leaves(tree))


def _build(name, A):
    from rocalution_tpu.parallel import (block_jacobi_precond,
                                         distributed_amg_setup)

    Ag = distribute_csr(A, NP)
    if name == "distribute_csr":
        return Ag
    if name == "block_jacobi_diag":
        return block_jacobi_diag(Ag)
    if name == "block_jacobi_precond":
        return block_jacobi_precond(Ag, "ilu0").arrays
    if name == "distribute_vector":
        return distribute_vector(np.ones(A.shape[0]), NP, Ag.n_local)
    coo = [m.tocoo() for m in Ag._block_cache[0]]
    blocks = [(c.row, c.col, c.data) for c in coo]
    return distributed_amg_setup(blocks, A.shape, coarse_size=40)


@pytest.mark.parametrize("name", [
    "distribute_csr", "block_jacobi_diag", "block_jacobi_precond",
    "distribute_vector", "distributed_amg_setup"])
def test_constructors_place_part_p_on_device_p(problem, name):
    """Every stacked (P, ...) array leaves its constructor with part p on
    the p-th device of make_mesh(P), not gathered on the default device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    A, _, _ = problem
    tree = _build(name, A)
    want = NamedSharding(make_mesh(NP), P("p"))
    assert _spread(tree) == NP
    for leaf in jax.tree.leaves(tree):
        assert leaf.sharding.is_equivalent_to(want, leaf.ndim), name


@pytest.mark.parametrize("where", ["one_device", "other_devices"])
def test_dist_solve_places_operands_on_its_mesh(problem, where):
    """Operands committed elsewhere (all on one device, or on the mesh of
    other devices) are moved onto the solve's mesh; the iterate comes back
    spread over that mesh."""
    A, b, x_true = problem
    Ag = distribute_csr(A, NP)
    M = block_jacobi_diag(Ag)
    if where == "one_device":
        Ag, M = jax.device_put((Ag, M), jax.devices()[0])
    mesh = make_mesh(NP, jax.devices()[-NP:])
    x, info = dist_solve(cg, Ag, b, M=M, mesh=mesh, rel_tol=1e-10,
                         max_iter=500)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-6
    assert {s.device for s in x.addressable_shards} == set(
        mesh.devices.flat)


def test_dist_amg_sharded_places_hierarchy_on_its_mesh(problem):
    from rocalution_tpu.parallel import dist_amg_solve_sharded

    A, b, x_true = problem
    dl = _build("distributed_amg_setup", A)
    mesh = make_mesh(NP, jax.devices()[-NP:])
    x, info = dist_amg_solve_sharded(cg, dl, b, mesh=mesh, rel_tol=1e-10,
                                     max_iter=200)
    assert int(info.status) in (1, 2)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-6
    assert {s.device for s in x.addressable_shards} == set(
        mesh.devices.flat)


def test_shard_stacked_keeps_placed_arrays(problem):
    from rocalution_tpu.parallel.partition import shard_stacked

    A, _, _ = problem
    Ag = distribute_csr(A, NP)
    assert shard_stacked(Ag.int_data, make_mesh(NP)) is Ag.int_data
