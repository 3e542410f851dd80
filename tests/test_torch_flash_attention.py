"""The port's attention against the JAX package's, on the CPU.

The port's ``kernels.flash_attention.flash_attention`` on a CPU tensor is
its plain version (``ref.attention_ref``); the CUDA kernel itself is held
to it on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here
it meets the Pallas kernel in interpret mode and the JAX oracle, over the
shapes of ``tests/test_kernels.py``, inputs from numpy with a seed. The
tolerances are that file's: 2e-5 in f32, 2e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.models.attention import plain_attention

FLASH_CASES = [
    # (bh, bhkv, sq, skv, hd, causal, window, dtype)
    (4, 2, 256, 256, 64, True, 0, "float32"),
    (4, 4, 128, 128, 32, False, 0, "float32"),      # bidirectional
    (8, 2, 200, 200, 64, True, 64, "float32"),      # ragged + SWA
    (2, 1, 384, 384, 128, True, 128, "float32"),    # deep GQA + window
    (2, 2, 128, 128, 64, True, 0, "bfloat16"),
    (6, 3, 96, 160, 64, False, 0, "float32"),       # cross lengths
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(shapes, dtype, seed=0):
    g = np.random.default_rng(seed)
    arrays = [g.standard_normal(s, np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_port_flash_vs_pallas_interpret_and_oracle(case):
    bh, bhkv, sq, skv, hd, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(
        [(bh, sq, hd), (bhkv, skv, hd), (bhkv, skv, hd)], dtype)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=64, block_k=64, interpret=True)
    oracle = jax_ref.attention_ref(jq, jk, jv, causal=causal, window=window,
                                   scale=hd ** -0.5)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), atol=TOL[dtype])


@pytest.mark.parametrize("b,s,h,hkv,hd,causal,window", [
    (2, 40, 4, 2, 16, True, 0),
    (1, 37, 6, 3, 32, True, 16),      # ragged, windowed, GQA group 2
    (3, 24, 2, 1, 64, False, 0),      # bidirectional, one kv head
])
def test_head_fold_wrapper_vs_jax_ops(b, s, h, hkv, hd, causal, window):
    """The (B, S, H, hd) wrapper folds q heads (B, Hkv, G) as
    ``repro.kernels.ops`` does: q row bh reads kv row bh // G."""
    (jq, jk, jv), (q, k, v) = _inputs(
        [(b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)], "float32", seed=3)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = jax_ops.flash_attention(jq, jk, jv, causal=causal, window=window)
    assert got.shape == (b, s, h, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    plain = plain_attention(q, k, v, causal=causal, window=window,
                            scale=hd ** -0.5)
    np.testing.assert_allclose(_np(plain), _np(got), atol=0)


def test_head_fold_groups_query_heads_by_kv_head():
    """With one distinct value per kv head, each q head must read the kv
    head of its group (h // G)."""
    b, s, h, hkv, hd = 2, 5, 6, 3, 4
    q = torch.zeros((b, s, h, hd))
    k = torch.zeros((b, s, hkv, hd))
    v = torch.arange(b * hkv, dtype=torch.float32).reshape(b, 1, hkv, 1) \
        .expand(b, s, hkv, hd).contiguous()
    out = ops.flash_attention(q, k, v, causal=False)
    for bi in range(b):
        for head in range(h):
            assert torch.all(out[bi, :, head] == bi * hkv + head // (h // hkv))


def test_wrapper_checks_its_inputs():
    q = torch.zeros((4, 8, 16))
    with pytest.raises(ValueError, match="fold"):
        fa.flash_attention(q, q[:3], q[:3])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           q, q)
    with pytest.raises(ValueError, match="must be"):
        fa.flash_attention(q, q[:, :, :8], q[:, :, :8])


def test_cpu_tensors_take_the_plain_version():
    """No kernel launch for a CPU tensor: the result is attention_ref's."""
    (_, _, _), (q, k, v) = _inputs([(4, 9, 8), (2, 9, 8), (2, 9, 8)],
                                   "float32")
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=True, window=4)
    assert fa.LAUNCHES == before
    torch.testing.assert_close(
        got, attention_ref(q, k, v, causal=True, window=4, scale=8 ** -0.5),
        rtol=0, atol=0)
