"""The port's ``kernels/ops.py`` exposes every kernel the reference's does
(``flash_attention``, ``rglru_scan``, ``pe_execute``): on CPU tensors each
wrapper equals its plain version and the JAX package's ``kernels.ops``
(Pallas in interpret mode), on seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.ggpu import isa
from repro_torch.ggpu.engine.alu import select_alu
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rglru_scan_ref


def test_ops_names_every_reference_kernel():
    for name in ("flash_attention", "rglru_scan", "pe_execute"):
        assert callable(getattr(ops, name)) and hasattr(jax_ops, name)


@pytest.mark.parametrize("b,s,d", [(2, 37, 16), (1, 130, 5)])
def test_ops_rglru_scan_equals_plain_and_reference(b, s, d):
    g = np.random.default_rng(s + d)
    a = g.uniform(0.5, 1.0, (b, s, d)).astype(np.float32)
    x = g.standard_normal((b, s, d)).astype(np.float32)
    h0 = g.standard_normal((b, d)).astype(np.float32)
    h, hf = ops.rglru_scan(*map(torch.from_numpy, (a, x, h0)))
    ph, phf = rglru_scan_ref(*map(torch.from_numpy, (a, x, h0)))
    assert torch.equal(h, ph) and torch.equal(hf, phf)
    jh, jhf = jax_ops.rglru_scan(*map(jnp.asarray, (a, x, h0)))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jhf), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("w,l", [(8, 64), (9, 5)])
def test_ops_pe_execute_equals_plain_and_reference(w, l):
    g = np.random.default_rng(w * l)
    op = g.integers(0, isa.N_OPS, (w, 1)).astype(np.int32)
    imm = g.integers(-2**15, 2**15, (w, 1)).astype(np.int32)
    a = g.integers(-2**31, 2**31, (w, l)).astype(np.int32)
    b = g.integers(-2**31, 2**31, (w, l)).astype(np.int32)
    t = [torch.from_numpy(x) for x in (op, imm, a, b)]
    got = ops.pe_execute(*t)
    assert torch.equal(got, select_alu(t[0], t[2], t[3], t[1]))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ops.pe_execute(*map(jnp.asarray,
                                                         (op, imm, a, b)))))
    mask = frozenset({isa.ADD, isa.MUL})
    assert torch.equal(ops.pe_execute(*t, mask),
                       select_alu(t[0], t[2], t[3], t[1], mask))
