"""Backend / platform management.

Replacement for the reference runtime layer
(reference: src/base/backend_manager.cpp:110 `init_rocalution`,
:213 `stop_rocalution`, :287 `info_rocalution`). Under JAX there are no
handles or streams to create: JAX owns the runtime. What remains useful:

* `init(...)`   — optional `jax.distributed.initialize` for multi-host runs
                  (replaces MPI_Init + per-rank device selection),
* `info()`      — platform dump,
* `stop()`      — no-op kept for API parity,
* `sync()`      — block until all pending work is done (used by benchmarks,
                  analog of `_rocalution_sync()`),
* `use_compile_cache()` — JAX's persistent compilation cache for scripts.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from .config import get_config

_initialized = False


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Initialize the runtime (analog of init_rocalution, backend_manager.cpp:110).

    Single-process use needs no arguments. Multi-host use passes the
    coordinator address (replaces MPI_Init + `init_rocalution(rank, dev)`).
    """
    global _initialized
    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    _initialized = True


def stop() -> None:
    """API-parity no-op (analog of stop_rocalution, backend_manager.cpp:213)."""
    global _initialized
    _initialized = False


def sync() -> None:
    """Block until all in-flight device work completes (analog _rocalution_sync)."""
    for d in jax.local_devices():
        jax.device_put(0, d).block_until_ready()


# a fixed path inside the checkout, so every script run from it shares
# what earlier runs compiled
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    is set here; otherwise the cache goes to ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def info() -> str:
    """Platform description (analog of info_rocalution, backend_manager.cpp:287)."""
    cfg = get_config()
    lines = [
        "rocalution_tpu platform info:",
        f"  jax version      : {jax.__version__}",
        f"  backend          : {jax.default_backend()}",
        f"  process          : {jax.process_index()}/{jax.process_count()}",
        f"  local devices    : {jax.local_devices()}",
        f"  global devices   : {jax.device_count()}",
        f"  default dtype    : {cfg.default_dtype}",
        f"  index dtype      : {cfg.index_dtype}",
        f"  x64 enabled      : {jax.config.jax_enable_x64}",
    ]
    out = "\n".join(lines)
    if cfg.verbose >= 1:
        print(out)
    return out
