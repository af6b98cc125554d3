"""chip_smoke.py: refuses to run without a GPU, and every phase's checks
pass at tiny sizes on the CPU (the card runs them at full size)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


TINY = {
    "phase_spmv": dict(n3d=10, n_rand=2000, n_rand_ell=3000, n_dense=128,
                       time_csr=False),
    "phase_cg_jacobi": dict(n=12),
    "phase_cg_amg": dict(n=14, coarse_size=100),
    "phase_gmres_ilu": dict(n=40),
    "phase_mpdc": dict(n=12),
    "phase_fem_ilu": dict(npts=2000),
    "phase_dist_cg": dict(n=12, nparts=4),
    "phase_dist_amg": dict(n=10, nparts=4, coarse_size=100),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_at_tiny_size(phase):
    out = getattr(chip_smoke, phase)(**TINY[phase])
    assert isinstance(out, dict) and out


def test_phase_tables_cover_every_phase():
    names = {fn.__name__ for _, fn in
             chip_smoke.PHASES + chip_smoke.FOUR_PHASES}
    assert names == set(TINY)


def test_spmv_phase_reports_csr_rates(monkeypatch):
    """Phase 1's timed CSR rows, with the peak of a stand-in card (the CPU
    has no published bandwidth)."""
    from rocalution_tpu.utils import timing

    monkeypatch.setattr(timing, "hbm_gbps", lambda kind: 100.0)
    out = chip_smoke.phase_spmv(n3d=8, n_rand=500, n_rand_ell=600,
                                n_dense=64, time_csr=True)
    for dt in ("float64", "float32"):
        assert out[f"csr_{dt}_us_per_apply"] > 0
        assert out[f"csr_{dt}_share_of_100_gbps"] == pytest.approx(
            out[f"csr_{dt}_gbps"] / 100.0)
