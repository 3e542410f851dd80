"""The port's RG-LRU recurrence against the JAX package's, on the CPU.

The port's ``kernels.rglru_scan.rglru_scan`` on a CPU tensor is its plain
version (``ref.rglru_scan_ref``, sequential); the CUDA kernel is held to
it on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here it
meets the Pallas kernel in interpret mode and the JAX oracle at 1e-5, and
the split-and-carry property holds at 1e-4, as in
``tests/test_kernels.py``. The model's plain path, ``linear_scan``, sums
in another order (a log-depth scan, like the reference's associative
scan): 1e-5 against the sequential oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.rglru_scan import rglru_scan as jax_rglru
from repro.models.recurrent import linear_scan as jax_linear_scan
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels.ref import rglru_scan_ref
from repro_torch.models.recurrent import linear_scan


def _inputs(b, s, d, seed):
    g = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-g.standard_normal((b, s, d))))
    x = g.standard_normal((b, s, d))
    h0 = g.standard_normal((b, d))
    arrays = [np.asarray(t, np.float32) for t in (a, x, h0)]
    return [jnp.asarray(t) for t in arrays], [torch.from_numpy(t)
                                              for t in arrays]


@pytest.mark.parametrize("b,s,d", [(1, 64, 128), (3, 100, 96), (2, 17, 40)])
def test_port_scan_vs_pallas_interpret_and_oracle(b, s, d):
    (ja, jx, jh0), (a, x, h0) = _inputs(b, s, d, seed=s)
    h, hf = rg.rglru_scan(a, x, h0)
    ph, phf = jax_rglru(ja, jx, jh0, block_d=64, chunk=16, interpret=True)
    rh, rhf = jax_ref.rglru_scan_ref(ja, jx, jh0)
    for got, want in ((h, ph), (hf, phf), (h, rh), (hf, rhf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("s,b", [(2, 1), (5, 3), (16, 2), (29, 1)])
def test_split_and_carry(s, b):
    """Scanning [0:k) then [k:S) with the carried state == scanning [0:S),
    for the port and for the Pallas kernel it replaces."""
    (ja, jx, jh0), (a, x, h0) = _inputs(b, s, 16, seed=s * 7 + b)
    cut = max(1, s // 2)
    h_full, hf_full = rglru_scan_ref(a, x, h0)
    _, hf1 = rg.rglru_scan(a[:, :cut].contiguous(), x[:, :cut].contiguous(),
                           h0)
    h2, hf2 = rg.rglru_scan(a[:, cut:].contiguous(), x[:, cut:].contiguous(),
                            hf1)
    torch.testing.assert_close(hf2, hf_full, rtol=0, atol=1e-4)
    torch.testing.assert_close(h2, h_full[:, cut:], rtol=0, atol=1e-4)
    _, jhf1 = jax_rglru(ja[:, :cut], jx[:, :cut], jh0, chunk=8)
    jh2, _ = jax_rglru(ja[:, cut:], jx[:, cut:], jhf1, chunk=8)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), atol=1e-4)


@pytest.mark.parametrize("s", [1, 2, 7, 64, 100])
def test_linear_scan_vs_sequential_and_jax(s):
    (ja, jx, jh0), (a, x, h0) = _inputs(2, s, 24, seed=s + 11)
    h, hf = linear_scan(a, x, h0)
    rh, rhf = rglru_scan_ref(a, x, h0)
    torch.testing.assert_close(h, rh, rtol=0, atol=1e-5)
    torch.testing.assert_close(hf, rhf, rtol=0, atol=1e-5)
    jh, jhf = jax.jit(jax_linear_scan)(ja, jx, jh0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jhf), atol=1e-5)


def test_wrapper_checks_its_inputs():
    a = torch.zeros((2, 5, 8))
    with pytest.raises(TypeError, match="float32"):
        rg.rglru_scan(a.double(), a.double(), a[:, 0].double())
    with pytest.raises(ValueError, match="h0"):
        rg.rglru_scan(a, a, a[:1, 0])
    with pytest.raises(ValueError, match="contiguous"):
        rg.rglru_scan(a.transpose(0, 1).contiguous().transpose(0, 1), a,
                      a[:, 0].contiguous())
    before = rg.LAUNCHES
    rg.rglru_scan(a, a, a[:, 0].contiguous())
    assert rg.LAUNCHES == before                # a CPU tensor: no launch
