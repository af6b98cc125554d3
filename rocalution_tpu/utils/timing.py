"""Device timing for benchmarks and the smoke run (reference methodology:
clients/samples/benchmark.cpp:104-380).

* every timing ends in `jax.block_until_ready`; operands are passed to the
  jitted program as arguments, never closed over;
* a per-op time jits a `fori_loop` chain of K dependent applications:
  per-op = (t(2K) - t(K)) / K, which cancels dispatch overhead and defeats
  loop-invariant hoisting (each iteration's operand depends on the
  previous result);
* compilation is warmed before any timed call;
* a rate is divided by the card's published memory bandwidth, looked up by
  `device_kind`; an unknown card is an error, never a guess.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np

# Published device-memory bandwidth in GB/s, keyed by `device_kind`.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5: 3.35 TB/s HBM3).
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def hbm_gbps(kind: str) -> float:
    """Published memory bandwidth of `kind`; an unknown device is an error."""
    try:
        return PEAK_HBM_GBPS[kind]
    except KeyError:
        raise KeyError(
            f"no published memory bandwidth for device kind {kind!r}; "
            f"add it to PEAK_HBM_GBPS with its source") from None


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` of the visible cards as nvidia-smi prints them,
    one card per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def chain_time(step, x0, *ops, K_max=20000, trials=3, budget_s=0.25,
               probe=66):
    """Seconds per application of `step` (x, *ops -> x), timed as a
    dependent chain: (t(2K) - t(K)) / K. The rep count is a traced
    fori_loop bound, so one compile serves every K; K adapts so one trial
    stays within `budget_s`. `probe` is the chain length of the initial
    estimation run."""
    import jax

    @jax.jit
    def run(v, k, *ops):
        return jax.lax.fori_loop(0, k, lambda i, c: step(c, *ops), v)

    def timed(k):
        t0 = time.perf_counter()
        jax.block_until_ready(run(x0, k, *ops))
        return time.perf_counter() - t0

    timed(2)                               # compile
    est = max((timed(probe) - timed(2)) / (probe - 2), 1e-9)
    K = int(max(2, min(K_max, budget_s / est)))
    timed(K)
    timed(2 * K)                           # warm
    t1 = min(timed(K) for _ in range(trials))
    t2 = min(timed(2 * K) for _ in range(trials))
    return max((t2 - t1) / K, 1e-12)


def solve_time(solve, *args, trials=3):
    """Best-of-N wall time of a jitted solve returning (x, iters, res)."""
    import jax

    jax.block_until_ready(solve(*args))    # compile + warm
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        _, iters, res = jax.block_until_ready(solve(*args))
        best = min(best, time.perf_counter() - t0)
    return best, int(iters), float(res)


def spmv_rate(A, seed: int = 0, **chain_kw):
    """(seconds per apply, GB/s) of `spmv(A, x)` in A's format and dtype,
    GB/s by the reference byte model (sizeof(T) + sizeof(int)) * nnz
    (benchmark.cpp:210-380). The chained iterate is scaled by 1/‖A‖∞ so it
    stays bounded. `chain_kw` goes to `chain_time`."""
    import jax.numpy as jnp

    from ..formats import to_csr
    from ..ops.spmv import spmv

    dt = np.dtype(A.dtype)
    data, _, ptr = to_csr(A).numpy_triplet()
    rows = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    norm_inf = np.bincount(rows, np.abs(data).astype(np.float64)).max()
    scale = dt.type(1.0 / norm_inf)
    x = jnp.asarray(np.random.default_rng(seed)
                    .standard_normal(A.shape[1]).astype(dt))
    t = chain_time(lambda c, B: spmv(B, c) * scale, x, A, **chain_kw)
    return t, (dt.itemsize + 4) * A.nnz / t / 1e9
