"""Device timing helpers: the peak table refuses unknown cards, and the
chained SpMV timer returns a positive time and the reference byte-model
rate on whatever backend runs it."""

import numpy as np
import pytest

import rocalution_tpu as rt
from rocalution_tpu.utils import timing


def test_peak_of_known_card():
    assert timing.hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                                  "cpu"])
def test_peak_of_unknown_card_is_an_error(kind):
    with pytest.raises(KeyError, match="no published memory bandwidth"):
        timing.hbm_gbps(kind)


@pytest.mark.parametrize("fmt,dtype", [("CSR", np.float64),
                                       ("CSR", np.float32),
                                       ("DIA", np.float32)])
def test_spmv_rate_byte_model(fmt, dtype):
    A = rt.convert(rt.laplacian_2d(40, dtype=dtype), fmt)
    t, gbps = timing.spmv_rate(A, budget_s=0.01, probe=6, trials=1)
    assert t > 0
    assert gbps == pytest.approx(
        (np.dtype(dtype).itemsize + 4) * A.nnz / t / 1e9)


def test_chain_time_counts_dependent_steps():
    import jax.numpy as jnp

    x = jnp.ones(1000, jnp.float32)
    t = timing.chain_time(lambda c: c * np.float32(0.5), x, budget_s=0.01,
                          probe=6, trials=1)
    assert 0 < t < 1.0
