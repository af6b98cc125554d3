"""Benchmark harness (reference methodology: clients/samples/benchmark.cpp,
clients/benchmarks/rocalution_bench_solver_results.hpp:33-78).

Run on a GPU: ``python bench.py``. It refuses any other backend.

Emits the headline JSON line on stdout after EVERY completed section
(flushed, one line each, monotonically growing `detail`), so a timeout kill
still leaves a parseable record — the last complete line is the record.
Per-op details go to stderr. A failed section is logged with its traceback,
the run goes on, and the process exits non-zero at the end.

Measurement protocol: `rocalution_tpu.utils.timing` (block_until_ready
after warm-up; per-op times from dependent fori_loop chains). Chained ops
keep magnitudes bounded with a fused scalar rescale (no extra memory
traffic).

Headline metric: **CSR SpMV bandwidth (GB/s, f32)** on a 3D Laplacian
(`laplacian_3d(100)`: 1.0M rows, 6.9M nnz) through the XLA path
(gather + `segment_sum`, ops/spmv.py), using the reference's byte model
`(sizeof(T)+sizeof(int)) * nnz` (benchmark.cpp:210-380), reported against
the card's published memory bandwidth (`timing.PEAK_HBM_GBPS`). DIA is
additionally reported with its OWN byte model (values + x + y, no index
bytes).

End-to-end solver rows follow the reference bench results struct
(time_analyze = host setup/factorization, time_solve = device solve):
GMRES(30)+ILU(0) on nonsymmetric convection-diffusion, CG+IC(0), CG+Jacobi,
CG+SA-AMG, MixedPrecisionDC(f64 outer / f32 CG inner) and CG+ILU(0) on an
unstructured FEM operator.
"""

import json
import sys
import time
import traceback

import numpy as np

from rocalution_tpu.utils.timing import (chain_time, gpu_name_and_power_limit,
                                         hbm_gbps, solve_time, spmv_rate)


def main():
    import jax
    import jax.numpy as jnp

    import rocalution_tpu as rt
    from rocalution_tpu.precond.jacobi import inverse_diagonal

    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    if jax.default_backend() != "gpu":
        log(f"bench.py measures a GPU; JAX backend is "
            f"{jax.default_backend()!r}")
        return 2
    rt.backend.use_compile_cache()
    dev = jax.devices()[0]
    roof = hbm_gbps(dev.device_kind)
    card = gpu_name_and_power_limit()
    log("devices:", jax.devices(), "|", card)
    t_start = time.monotonic()

    dtype = np.float32
    vsize = np.dtype(dtype).itemsize

    results = {}
    sections = []
    failed = []

    def emit(section):
        """Print the (updated) headline JSON line — one line per section."""
        sections.append(section)
        value = results.get("spmv_csr_gbps", 0.0)
        print(json.dumps({
            "metric": "spmv_csr_f32_bandwidth",
            "value": value,
            "unit": "GB/s",
            "vs_peak": value / roof,
            "peak_gbps": roof,
            "detail": results,
            "sections": list(sections),
            "failed": list(failed),
            "card": card,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "elapsed_s": time.monotonic() - t_start,
        }), flush=True)

    def section(name, fn):
        t0 = time.monotonic()
        try:
            fn()
        except Exception:
            log(f"[FAIL] {name}:")
            traceback.print_exc(file=sys.stderr)
            failed.append(name)
            return
        log(f"[done] {name} ({time.monotonic() - t0:.1f}s)")
        emit(name)

    # ============ 1. end-to-end solver rows ==============================
    A2 = rt.laplacian_2d(256, dtype=dtype)                  # 65k unknowns
    b2 = jnp.asarray(np.asarray(rt.spmv(A2, np.ones(A2.shape[0], dtype))))
    A2dia = rt.convert(A2, "DIA")
    invd2 = inverse_diagonal(A2)

    def sec_cg_jacobi():
        @jax.jit
        def solve(A, invd, b):
            x, info = rt.cg(A, b, M=lambda r: invd * r,
                            rel_tol=1e-6, max_iter=1000)
            return x, info.iterations, info.final_res

        best, iters, res = solve_time(solve, A2dia, invd2, b2)
        results["cg_jacobi_65k_ms"] = best * 1e3
        results["cg_jacobi_65k_iters"] = iters
        log(f"cg+jacobi: iters={iters} final_res={res:.3e}")

    section("cg_jacobi", sec_cg_jacobi)

    def sec_cg_ic():
        from rocalution_tpu.precond import ic

        t0 = time.perf_counter()
        M_ic = ic(A2, method="jacobi", sweeps=8)
        results["cg_ic0_65k_analyze_ms"] = (time.perf_counter() - t0) * 1e3

        @jax.jit
        def solve(A, b):
            x, info = rt.cg(A, b, M=M_ic, rel_tol=1e-8, max_iter=1000)
            return x, info.iterations, info.final_res

        best, iters, res = solve_time(solve, A2dia, b2)
        results["cg_ic0_65k_solve_ms"] = best * 1e3
        results["cg_ic0_65k_iters"] = iters
        log(f"cg+ic0: iters={iters} final_res={res:.3e}")

    section("cg_ic0", sec_cg_ic)

    def sec_gmres_ilu():
        from rocalution_tpu.precond import ilu

        Acd = rt.convection_diffusion_2d(192, dtype=dtype)  # 36.8k unknowns
        bcd = jnp.asarray(np.random.default_rng(4)
                          .standard_normal(Acd.shape[0]).astype(dtype))
        t0 = time.perf_counter()
        M_ilu = ilu(Acd, 0, method="jacobi", sweeps=8)
        results["gmres_ilu0_37k_analyze_ms"] = (
            (time.perf_counter() - t0) * 1e3)

        @jax.jit
        def solve(A, b):
            x, info = rt.gmres(A, b, M=M_ilu, basis_size=30,
                               rel_tol=1e-8, max_iter=600)
            return x, info.iterations, info.final_res

        best, iters, res = solve_time(solve, Acd, bcd)
        results["gmres_ilu0_37k_solve_ms"] = best * 1e3
        results["gmres_ilu0_37k_iters"] = iters
        log(f"gmres30+ilu0: iters={iters} final_res={res:.3e}")

    section("gmres_ilu0", sec_gmres_ilu)

    def sec_amg():
        from rocalution_tpu.solvers.multigrid import (amg_hierarchy,
                                                      convert_hierarchy,
                                                      cycle_closure)

        A2h = rt.laplacian_2d(256, dtype=np.float64)  # setup wants f64 host
        t0 = time.perf_counter()
        hier = amg_hierarchy(A2h, "sa", coarse_size=300)
        hier = convert_hierarchy(hier, dtype=np.float32)
        results["amg_setup_ms"] = (time.perf_counter() - t0) * 1e3
        M = cycle_closure(hier)
        A0 = hier.levels[0].A

        @jax.jit
        def solve(A, b):
            x, info = rt.cg(A, b, M=M, rel_tol=1e-6, max_iter=200)
            return x, info.iterations, info.final_res

        best, iters, res = solve_time(solve, A0, b2)
        results["cg_saamg_65k_ms"] = best * 1e3
        results["cg_saamg_65k_iters"] = iters
        log(f"cg+saamg: iters={iters} final_res={res:.3e} "
            f"levels={hier.num_levels}")

    section("cg_saamg", sec_amg)

    def sec_mpdc():
        A1664 = rt.laplacian_2d(128, dtype=np.float64)      # 16k unknowns
        b16 = jnp.asarray(
            np.random.default_rng(5).standard_normal(A1664.shape[0]))

        def run():
            x_mp, info_mp = rt.mixed_precision_dc(
                A1664, b16, rel_tol=1e-10, max_iter=20,
                inner_kwargs={"rel_tol": 1e-4, "max_iter": 2000},
            )
            jax.block_until_ready(x_mp)
            return info_mp

        run()                              # compile + warm
        t0 = time.perf_counter()
        info_mp = run()
        results["mpdc_16k_ms"] = (time.perf_counter() - t0) * 1e3
        results["mpdc_16k_iters"] = int(info_mp.iterations)
        log(f"mpdc: outer_iters={int(info_mp.iterations)} "
            f"res={float(info_mp.final_res):.3e}")

    section("mpdc", sec_mpdc)

    # ---- AMG setup at scale: host-native fused Galerkin build, 2.1M
    # unknowns ----
    def sec_amg_setup_2m():
        from rocalution_tpu.solvers.multigrid import amg_hierarchy

        A3h = rt.laplacian_3d(128, dtype=np.float64)
        t0 = time.perf_counter()
        h = amg_hierarchy(A3h, "sa", coarse_size=300)
        results["amg_setup_2m_ms"] = (time.perf_counter() - t0) * 1e3
        results["amg_setup_2m_levels"] = len(h.levels)
        log(f"amg setup 2.1M: {results['amg_setup_2m_ms']:.0f} ms "
            f"levels={[lv.A.shape[0] for lv in h.levels]}")

    section("amg_setup_2m", sec_amg_setup_2m)

    # ============ 2. BLAS-1 (reference formulas, benchmark.cpp:104-206) ==
    NV = 1000000
    x = jnp.asarray(
        (np.random.default_rng(0).standard_normal(NV) / NV).astype(dtype))
    y = jnp.asarray(np.random.default_rng(1).standard_normal(NV).astype(dtype))

    def sec_blas1():
        t_axpy = chain_time(lambda c, y: c + np.float32(1e-6) * y, x, y)
        results["axpy_gbps"] = 3 * NV * vsize / t_axpy / 1e9
        t_dotaxpy = chain_time(
            lambda c, y: c + (np.float32(1e-12) * jnp.dot(c, y)) * y, x, y
        )
        results["dot_axpy_gbps"] = 5 * NV * vsize / t_dotaxpy / 1e9
        t_normaxpy = chain_time(
            lambda c, y: c + (np.float32(1e-12) * jnp.sqrt(jnp.dot(c, c)))
            * y, x, y
        )
        results["norm_axpy_gbps"] = 5 * NV * vsize / t_normaxpy / 1e9

    section("blas1", sec_blas1)

    # ============ 3. headline: CSR SpMV (3D Laplacian, 1M rows) ==========
    A = rt.laplacian_3d(100, dtype=dtype)
    nnz = A.nnz
    N = A.shape[0]
    log(f"matrix: laplacian_3d(100)  N={N}  nnz={nnz}  "
        f"dtype={np.dtype(dtype).name}")

    def sec_csr():
        t, results["spmv_csr_gbps"] = spmv_rate(A)
        results["spmv_csr_gflops"] = 2 * nnz / t / 1e9
        results["spmv_csr_us"] = t * 1e6
        log(f"  spmv[csr] {t*1e6:9.1f} us/apply")

    section("csr", sec_csr)

    # ============ 4. DIA (same matrix, own byte model too) ===============
    def sec_dia():
        B = rt.convert(A, "DIA")
        t, results["spmv_dia_gbps"] = spmv_rate(B)
        results["spmv_dia_gflops"] = 2 * nnz / t / 1e9
        own = vsize * (B.data.shape[0] * N + 2 * N)
        results["spmv_dia_own_model_gbps"] = own / t / 1e9
        log(f"  spmv[dia] {t*1e6:9.1f} us/apply")

    section("dia", sec_dia)

    # ============ 5. f64 CSR SpMV (same operator, native f64) ============
    def sec_f64():
        A64 = rt.laplacian_3d(100, dtype=np.float64)
        t, results["spmv_csr_f64_gbps"] = spmv_rate(A64)
        results["spmv_csr_f64_gflops"] = 2 * A64.nnz / t / 1e9
        log(f"  spmv[csr f64] {t*1e6:9.1f} us/apply")

    section("f64", sec_f64)

    # ============ 6. unstructured (banded random SPD, 1M rows) ===========
    def sec_rand():
        Ar = rt.random_banded_spd(1_000_000, dtype=dtype)
        t, results["spmv_csr_rand_gbps"] = spmv_rate(Ar)
        log(f"  spmv[csr rand-band] {t*1e6:9.1f} us/apply nnz={Ar.nnz}")

    section("rand_band", sec_rand)

    # ============ 7. remaining formats (65k matrix) ======================
    def fmt_section(name):
        def run():
            B = rt.convert(A2, name.upper())
            t, results[f"spmv_{name}_65k_gbps"] = spmv_rate(
                B, budget_s=0.05, probe=6, trials=2)
            log(f"  spmv[{name}/65k] {t*1e6:9.1f} us/apply")
        return run

    for fmt in ("ell", "hyb", "bcsr"):
        section(f"fmt_{fmt}", fmt_section(fmt))

    # ---- unstructured operator: P1 FEM on a random Delaunay mesh
    # (variable degree, irregular sparsity) ----
    def sec_fem():
        from rocalution_tpu.precond import ilu

        # f32 PARABOLIC operator (M + dt*K, the parabolic_fem semantics)
        # with level-scheduled exact tri-solves
        Af = rt.fem_2d_unstructured(120_000, dtype=np.float32,
                                    parabolic=True)
        bf = jnp.asarray(np.asarray(
            rt.spmv(Af, np.ones(Af.shape[0], np.float32))))
        t0 = time.perf_counter()
        # ILU(0) (not IC(0): FEM stiffness on obtuse triangles is SPD
        # but not an M-matrix, so IC can legitimately break down)
        M_f = ilu(Af, 0, method="levels")
        results["fem_ilu0_120k_analyze_ms"] = \
            (time.perf_counter() - t0) * 1e3

        @jax.jit
        def solve(A, b):
            x, info = rt.cg(A, b, M=M_f, rel_tol=1e-4, max_iter=200)
            return x, info.iterations, info.final_res

        best, iters, res = solve_time(solve, Af, bf)
        results["fem_ilu0_120k_solve_ms"] = best * 1e3
        results["fem_ilu0_120k_iters"] = iters
        log(f"fem cg+ilu0 120k: iters={iters} final_res={res:.3e}")

    section("fem_ilu0", sec_fem)

    for k, v in sorted(results.items()):
        log(f"  {k:28s} {v:12.4f}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
