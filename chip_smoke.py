"""Smoke run of the solver stack on NVIDIA GPUs, through the public API.

    python chip_smoke.py           # six phases on one card
    python chip_smoke.py --four    # the distributed phases on four cards

Start-up prints ``jax.devices()`` and the card's name and power limit, and
refuses any backend but ``gpu`` (exit 2): nothing here falls back to the
CPU. Each phase checks its result against a plain scipy/numpy f64
reference on the host and prints its numbers, its wall time and the card.
A failed phase prints its traceback; the run goes on to the next phase and
exits 1 at the end. On success the last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Default phases (one card):
  1. SpMV in every format at real width (1M rows; ELL on the random band
     at 32k rows), f64 and f32, plus DENSE f32 at 4096² (the TF32
     tripwire), with the CSR time per apply;
  2. CG + Jacobi, f64, 3D Poisson 128³ (2.1M unknowns);
  3. CG + SA-AMG, f64, same operator, plus the f32 hierarchy in DIA-auto and
     CSR form (clients/samples/poisson3d_large.py);
  4. GMRES(30) + ILU(0) on convection-diffusion 512² in f64 and f32;
  5. MixedPrecisionDC (f64 outer, f32 inner CG) on 3D Poisson 128³;
  6. CG + ILU(0) with level-scheduled triangular solves on a 120k-point
     unstructured FEM operator.
``--four`` runs only (b) distributed CG against one card and (a)
distributed SA-AMG on 3D Poisson 256³, and checks that the operator and
the iterate sit on four distinct devices as the library placed them.

The phase functions take their sizes as arguments so that the tests can
run them at tiny sizes on the CPU.
"""

import argparse
import json
import sys
import time
import traceback

import numpy as np

# reference tolerances: f32 sums run in another order than the f64 host
# reference, so f32 gets the looser bound; TF32 would err by ~1e-3
SPMV_TOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-5}
FORMATS = ("CSR", "COO", "ELL", "DIA", "HYB", "BCSR", "MCSR")
# ELL pads every row to the longest and DIA stores a full row per distinct
# diagonal; where that is more than PAD_MAX x nnz the format does not suit
# the operator. The random band has ~6k entries in its clipped edge rows
# and 16,385 diagonals whatever its size: ELL is checked on a smaller band
# (`n_rand_ell` rows) where its padding fits; DIA, one unrolled slice per
# diagonal, is not run on the band at all.
PAD_MAX = 4
# an f32 Krylov recursion drifts from the true residual by O(eps32·κ): an
# f32 solve's true residual may reach F32_DRIFT x its target
F32_DRIFT = 10


def _scipy(A, dtype=np.float64):
    """Host f64 scipy CSR of a CSR operator whose values are first rounded
    to `dtype`."""
    import scipy.sparse as sp

    d, i, p = A.numpy_triplet()
    return sp.csr_matrix((d.astype(dtype).astype(np.float64), i, p),
                         shape=A.shape)


def _rel_res(S, x, b):
    """‖b − S x‖ / ‖b‖ in f64 on the host."""
    x = np.asarray(x, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - S @ x) / np.linalg.norm(b))


def _rms_err_ones(x):
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(x - 1.0) / np.sqrt(x.shape[0]))


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _timed_solve(raw, b):
    """(result, first-call seconds incl. compile, second-call seconds) of a
    solve jitted with its closed-over operators lifted to arguments."""
    import jax

    from rocalution_tpu.utils import hoisted_jit

    solve = hoisted_jit(raw, b)
    t0 = time.perf_counter()
    jax.block_until_ready(solve(b))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(solve(b))
    return out, t_first, time.perf_counter() - t0


def phase_spmv(n3d=100, n_rand=1_000_000, n_rand_ell=32_768, n_dense=4096,
               time_csr=True):
    """SpMV in every format, f64 and f32, against scipy in f64."""
    import jax.numpy as jnp

    import rocalution_tpu as rt
    from rocalution_tpu.formats.convert import cast_values

    out = {}
    rng = np.random.default_rng(0)
    lap = rt.laplacian_3d(n3d, dtype=np.float64)
    cases = (
        ("laplacian_3d", lap, FORMATS),
        ("random_banded", rt.random_banded_spd(n_rand, dtype=np.float64),
         FORMATS),
        (f"random_banded_{n_rand_ell}",
         rt.random_banded_spd(n_rand_ell, dtype=np.float64), ("ELL",)))
    for name, A, fmts in cases:
        x64 = rng.standard_normal(A.shape[0])
        _, cols, ptr = A.numpy_triplet()
        padded = {"ELL": A.shape[0] * int(np.diff(ptr).max()),
                  "DIA": A.shape[0] * len(np.unique(cols - A.numpy_rows()))}
        # the reference multiplies the values each dtype actually holds
        ref_ops = {dt: _scipy(A, dt) for dt in (np.float64, np.float32)}
        for fmt in fmts:
            if fmts is FORMATS and padded.get(fmt, 0) > PAD_MAX * A.nnz:
                out[f"{name}/{fmt}"] = (
                    f"skipped: pads to {padded[fmt] / A.nnz:.0f}x nnz")
                continue
            B64 = rt.convert(A, fmt)
            for dt in (np.float64, np.float32):
                B = B64 if dt == np.float64 else cast_values(B64, dt)
                x = x64.astype(dt)
                y = np.asarray(rt.spmv(B, jnp.asarray(x)), np.float64)
                ref = ref_ops[dt] @ x.astype(np.float64)
                err = float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))
                key = f"{name}/{fmt}/{np.dtype(dt).name}"
                out[key] = err
                _check(y.shape == ref.shape and np.all(np.isfinite(y)),
                       f"{key}: bad output")
                _check(err <= SPMV_TOL[np.dtype(dt)],
                       f"{key}: rel max-norm error {err:.3e}")
    # DENSE f32: a TF32 product would err by ~1e-3 here
    Ad = rng.standard_normal((n_dense, n_dense)).astype(np.float32)
    xd = rng.standard_normal(n_dense).astype(np.float32)
    y = np.asarray(rt.spmv(rt.DENSE.from_array(Ad), jnp.asarray(xd)),
                   np.float64)
    ref = Ad.astype(np.float64) @ xd.astype(np.float64)
    err = float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))
    out["dense/DENSE/float32"] = err
    _check(err <= SPMV_TOL[np.dtype(np.float32)],
           f"DENSE f32: rel max-norm error {err:.3e} (TF32?)")
    if time_csr:
        out.update(_csr_rates(lap))
    return out


def _csr_rates(A64):
    """CSR SpMV time per apply and GB/s by the reference byte model
    (sizeof(T)+4)·nnz, f64 and f32, on the device."""
    import jax

    from rocalution_tpu.formats.convert import cast_values
    from rocalution_tpu.utils.timing import hbm_gbps, spmv_rate

    peak = hbm_gbps(jax.devices()[0].device_kind)
    out = {}
    for dt in (np.float64, np.float32):
        A = A64 if dt == np.float64 else cast_values(A64, dt)
        t, gbps = spmv_rate(A)
        name = np.dtype(dt).name
        out[f"csr_{name}_us_per_apply"] = t * 1e6
        out[f"csr_{name}_gbps"] = gbps
        out[f"csr_{name}_share_of_{peak:.0f}_gbps"] = gbps / peak
    return out


def _poisson(n):
    import rocalution_tpu as rt

    A = rt.laplacian_3d(n, dtype=np.float64)
    S = _scipy(A)
    return A, S, S @ np.ones(A.shape[0])


def phase_cg_jacobi(n=128):
    """CG + Jacobi, f64, b = A·1, to rel_tol 1e-8."""
    import rocalution_tpu as rt

    A, S, b = _poisson(n)
    M = rt.jacobi(A)

    def raw(b):
        x, info = rt.cg(A, b, M=M, rel_tol=1e-8, max_iter=20000)
        return x, info.iterations, info.status

    (x, it, status), t_first, t_solve = _timed_solve(raw, b)
    res, err = _rel_res(S, x, b), _rms_err_ones(x)
    out = {"n": A.shape[0], "nnz": A.nnz, "iters": int(it),
           "status": int(status), "true_rel_res": res, "rms_err": err,
           "first_call_s": t_first, "solve_s": t_solve}
    _check(int(status) in (1, 2), f"CG+Jacobi did not converge: {out}")
    _check(res <= 1e-7, f"CG+Jacobi true residual {res:.3e}")
    _check(err <= 1e-5, f"CG+Jacobi rms error {err:.3e}")
    return out


def phase_cg_amg(n=128, coarse_size=1000):
    """CG + SA-AMG, f64, to rel_tol 1e-10; then the f32 hierarchy with
    fmt="auto" and fmt="CSR" (f32 CG, rel_tol 1e-6) for their solve times."""
    import rocalution_tpu as rt
    from rocalution_tpu.solvers.multigrid import (amg_hierarchy,
                                                  convert_hierarchy,
                                                  cycle_closure)

    A, S, b = _poisson(n)
    t0 = time.perf_counter()
    h = amg_hierarchy(A, "sa", coarse_size=coarse_size)
    t_setup = time.perf_counter() - t0
    M = cycle_closure(h)

    def raw(b):
        x, info = rt.cg(A, b, M=M, rel_tol=1e-10, max_iter=200)
        return x, info.iterations, info.status

    (x, it, status), t_first, t_solve = _timed_solve(raw, b)
    res, err = _rel_res(S, x, b), _rms_err_ones(x)
    out = {"n": A.shape[0], "setup_s": t_setup,
           "levels": h.operator_sizes(), "iters": int(it),
           "status": int(status), "true_rel_res": res, "rms_err": err,
           "first_call_s": t_first, "solve_s": t_solve}
    _check(int(status) in (1, 2), f"CG+SA-AMG did not converge: {out}")
    _check(res <= 1e-9, f"CG+SA-AMG true residual {res:.3e}")
    _check(err <= 1e-6, f"CG+SA-AMG rms error {err:.3e}")

    b32 = b.astype(np.float32)
    for fmt in ("auto", "CSR"):
        h32 = convert_hierarchy(h, fmt=fmt, dtype=np.float32)
        M32 = cycle_closure(h32)
        A32 = h32.levels[0].A

        def raw32(b):
            x, info = rt.cg(A32, b, M=M32, rel_tol=1e-6, max_iter=200)
            return x, info.iterations, info.status

        (x, it, status), _, t = _timed_solve(raw32, b32)
        out[f"f32_{fmt}_formats"] = [type(lv.A).__name__
                                     for lv in h32.levels]
        out[f"f32_{fmt}_iters"] = int(it)
        out[f"f32_{fmt}_solve_s"] = t
        res32 = out[f"f32_{fmt}_true_rel_res"] = _rel_res(S, x, b32)
        _check(int(status) in (1, 2),
               f"f32 {fmt} hierarchy did not converge: status {int(status)}")
        _check(res32 <= F32_DRIFT * 1e-6,
               f"f32 {fmt} hierarchy true residual {res32:.3e}")
    return out


def phase_gmres_ilu(n=512, rel_tol=1e-5):
    """GMRES(30) + ILU(0) (jacobi sweeps) in f64 and f32; the f32 count
    must stay within 10% of the f64 count (TF32 in the CGS2 projections
    would lose orthogonality and add iterations)."""
    import rocalution_tpu as rt
    from rocalution_tpu.precond import ilu

    out = {}
    for dt in (np.float64, np.float32):
        A = rt.convection_diffusion_2d(n, dtype=dt)
        S = _scipy(A)
        b = np.random.default_rng(4).standard_normal(A.shape[0]).astype(dt)
        M = ilu(A, 0, method="jacobi", sweeps=8)

        def raw(b):
            x, info = rt.gmres(A, b, M=M, basis_size=30, rel_tol=rel_tol,
                               max_iter=5000)
            return x, info.iterations, info.status

        (x, it, status), _, t = _timed_solve(raw, b)
        name = np.dtype(dt).name
        res = _rel_res(S, x, b)
        out.update({f"{name}_iters": int(it), f"{name}_status": int(status),
                    f"{name}_true_rel_res": res, f"{name}_solve_s": t})
        _check(int(status) in (1, 2), f"GMRES {name} did not converge")
        _check(res <= (2 if dt == np.float64 else F32_DRIFT) * rel_tol,
               f"GMRES {name} true residual {res:.3e}")
    it64, it32 = out["float64_iters"], out["float32_iters"]
    _check(abs(it32 - it64) <= max(1, 0.1 * it64),
           f"GMRES iterations f32 {it32} vs f64 {it64}")
    return out


def phase_mpdc(n=128):
    """MixedPrecisionDC, f64 outer / f32 inner CG, to rel_tol 1e-10."""
    import jax

    import rocalution_tpu as rt

    A, S, b = _poisson(n)
    t0 = time.perf_counter()
    x, info = rt.mixed_precision_dc(A, b, rel_tol=1e-10)
    jax.block_until_ready(x)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = rt.mixed_precision_dc(A, b, rel_tol=1e-10)
    jax.block_until_ready(x)
    t_solve = time.perf_counter() - t0
    res = _rel_res(S, x, b)
    out = {"n": A.shape[0], "outer_iters": int(info.iterations),
           "status": int(info.status), "true_rel_res": res,
           "rms_err": _rms_err_ones(x), "first_call_s": t_first,
           "solve_s": t_solve}
    _check(int(info.status) in (1, 2), f"MPDC did not converge: {out}")
    _check(res <= 1e-9, f"MPDC true residual {res:.3e}")
    return out


def phase_fem_ilu(npts=120_000, rel_tol=1e-4):
    """CG + ILU(0) with level-scheduled triangular solves, f32 parabolic
    FEM operator on a random Delaunay mesh."""
    import rocalution_tpu as rt
    from rocalution_tpu.precond import ilu

    A = rt.fem_2d_unstructured(npts, dtype=np.float32, parabolic=True)
    S = _scipy(A)
    b = (S @ np.ones(A.shape[0])).astype(np.float32)
    t0 = time.perf_counter()
    M = ilu(A, 0, method="levels")
    t_setup = time.perf_counter() - t0

    def raw(b):
        x, info = rt.cg(A, b, M=M, rel_tol=rel_tol, max_iter=2000)
        return x, info.iterations, info.status

    (x, it, status), _, t_solve = _timed_solve(raw, b)
    res = _rel_res(S, x, b)
    out = {"n": A.shape[0], "nnz": A.nnz, "ilu_setup_s": t_setup,
           "iters": int(it), "status": int(status), "true_rel_res": res,
           "solve_s": t_solve}
    _check(int(status) in (1, 2), f"FEM CG+ILU(0) did not converge: {out}")
    _check(res <= F32_DRIFT * rel_tol,
           f"FEM CG+ILU(0) true residual {res:.3e}")
    return out


def _spread(tree):
    """The fewest distinct devices that any array leaf of `tree` sits on."""
    import jax

    return min(len({s.device for s in leaf.addressable_shards})
               for leaf in jax.tree.leaves(tree))


def phase_dist_cg(n=128, nparts=4):
    """Distributed CG + block-Jacobi (1x1 blocks = Jacobi) over `nparts`
    devices against single-device CG + Jacobi on the same system."""
    import rocalution_tpu as rt
    from rocalution_tpu.parallel import (block_jacobi_diag, dist_solve,
                                         distribute_csr, make_mesh)

    A, S, b = _poisson(n)
    mesh = make_mesh(nparts)
    Ag = distribute_csr(A, nparts)
    Mg = block_jacobi_diag(Ag)
    kw = dict(rel_tol=1e-8, max_iter=20000)
    t0 = time.perf_counter()
    xd, infod = dist_solve(rt.cg, Ag, b, M=Mg, mesh=mesh, **kw)
    xd_np = np.asarray(xd)
    t_dist = time.perf_counter() - t0
    t0 = time.perf_counter()
    x1, info1 = rt.cg(A, b, M=rt.jacobi(A), **kw)
    x1_np = np.asarray(x1)
    t_one = time.perf_counter() - t0
    diff = float(np.linalg.norm(xd_np - x1_np) / np.linalg.norm(x1_np))
    out = {"n": A.shape[0], "parts": nparts, "mode": Ag.mode,
           "dist_iters": int(infod.iterations),
           "one_iters": int(info1.iterations), "rel_diff": diff,
           "dist_true_rel_res": _rel_res(S, xd_np, b),
           "operator_devices": _spread(Ag),
           "precond_devices": _spread(Mg),
           "iterate_devices": _spread(xd),
           "dist_wall_s": t_dist, "one_wall_s": t_one}
    _check(int(infod.status) in (1, 2), f"distributed CG: {out}")
    _check(diff <= 1e-8, f"distributed vs one-device solution {diff:.3e}")
    _check(abs(out["dist_iters"] - out["one_iters"]) <= 2,
           f"iterations {out['dist_iters']} vs {out['one_iters']}")
    _check(out["operator_devices"] == out["precond_devices"]
           == out["iterate_devices"] == nparts,
           f"shards not on {nparts} distinct devices: {out}")
    return out


def phase_dist_amg(n=256, nparts=4, coarse_size=2000):
    """Distributed SA-AMG: per-part row blocks of the n³ Poisson operator
    (never assembled globally), `distributed_amg_setup`, then
    `dist_amg_solve_sharded(cg)` to rel_tol 1e-8 in f64."""
    from rocalution_tpu.parallel import (dist_amg_solve_sharded,
                                         distributed_amg_setup, make_mesh)
    from rocalution_tpu.parallel.amg_setup import _offsets
    from rocalution_tpu.solvers.krylov.cg import cg
    from rocalution_tpu.utils.generators import laplacian_3d_block

    N = n ** 3
    offs = _offsets(nparts, N)
    blocks = [laplacian_3d_block(n, int(offs[q]), int(offs[q + 1]))
              for q in range(nparts)]
    t0 = time.perf_counter()
    dl = distributed_amg_setup(blocks, (N, N), coarse_size=coarse_size)
    t_setup = time.perf_counter() - t0
    b = np.zeros(N)
    for q, (r, c, d) in enumerate(blocks):
        np.add.at(b, r + int(offs[q]), d)    # b = A·1 from the blocks alone
    mesh = make_mesh(nparts)
    t0 = time.perf_counter()
    x, info = dist_amg_solve_sharded(cg, dl, b, mesh=mesh, rel_tol=1e-8,
                                     max_iter=200)
    x_np = np.asarray(x)
    t_solve = time.perf_counter() - t0
    err = _rms_err_ones(x_np)
    out = {"n": N, "parts": nparts, "setup_s": t_setup,
           "levels": [int(A.n_global) for A in dl.As],
           "iters": int(info.iterations), "status": int(info.status),
           "rms_err": err, "wall_s": t_solve,
           "operator_devices": _spread(dl),
           "iterate_devices": _spread(x)}
    _check(int(info.status) in (1, 2), f"distributed AMG: {out}")
    _check(err <= 1e-5, f"distributed AMG rms error {err:.3e}")
    _check(out["operator_devices"] == nparts
           and out["iterate_devices"] == nparts,
           f"shards not on {nparts} distinct devices: {out}")
    return out


PHASES = (("1 spmv", phase_spmv), ("2 cg_jacobi", phase_cg_jacobi),
          ("3 cg_sa_amg", phase_cg_amg), ("4 gmres_ilu0", phase_gmres_ilu),
          ("5 mpdc", phase_mpdc), ("6 fem_cg_ilu0", phase_fem_ilu))
FOUR_PHASES = (("b dist_cg", phase_dist_cg), ("a dist_sa_amg", phase_dist_amg))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the distributed phases on four cards")
    args = ap.parse_args(argv)

    import jax

    import rocalution_tpu as rt

    print("devices:", jax.devices(), flush=True)
    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    from rocalution_tpu.utils.timing import gpu_name_and_power_limit

    card = "; ".join(gpu_name_and_power_limit().splitlines())
    print("card (name, power limit):", card, flush=True)
    rt.backend.use_compile_cache()
    phases = PHASES
    if args.four:
        if len(jax.devices()) < 4:
            print(f"--four needs 4 GPUs, JAX sees {len(jax.devices())}",
                  file=sys.stderr)
            return 2
        phases = FOUR_PHASES

    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            print(f"[FAIL] phase {name} after "
                  f"{time.perf_counter() - t0:.1f}s | {card}", flush=True)
            continue
        print(f"[ok] phase {name}: {json.dumps(res)} | wall "
              f"{time.perf_counter() - t0:.1f}s | {card}", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
