"""The port's attention against the JAX package's, on the CPU.

The port's ``kernels.flash_attention.flash_attention`` on a CPU tensor is
its plain version (``ref.attention_ref``); the CUDA kernel itself is held
to it on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here
it meets the Pallas kernel in interpret mode and the JAX oracle, over the
shapes of ``tests/test_kernels.py``, inputs from numpy with a seed. The
tolerances are that file's: 2e-5 in f32, 2e-2 in bf16.

The kernel's bf16 route runs on the tensor cores, and its arithmetic
differs from the plain version's: ``tensor_core_emulation`` replays it in
plain PyTorch (its tiles and tile skipping, the finite NEG_INF, bf16 q and
k with f32 sums, exp2 in log2 units, p split into two bf16 terms, one
rounding of the output), so that the numbers the card will give can be
held here against the Pallas kernel and the JAX oracle, at the limits
``chip_smoke.py`` holds the kernel to: 2e-2 absolute and, per query row,
1e-2 of the row's largest |o|.
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
from repro_torch.kernels.ref import NEG_INF, attention_ref
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
ROW_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}    # chip_smoke.py's
# the bf16 edges of the tensor-core route: hd not a multiple of 16; a
# window that is no multiple of the tile (rows meet a fully masked first
# tile); cross lengths; a window over a few heads at S ~ 1024 (hd 256:
# 32-row kv tiles)
TC_CASES = [(*c[:7], "bfloat16") for c in FLASH_CASES] + [
    (8, 2, 200, 200, 72, True, 64, "bfloat16"),
    (10, 1, 1000, 1000, 256, True, 300, "bfloat16"),
    (6, 3, 96, 160, 64, False, 0, "bfloat16"),
    (4, 1, 1024, 1024, 256, True, 300, "bfloat16"),
]


def _inputs(shapes, dtype, seed=0):
    g = np.random.default_rng(seed)
    arrays = [g.standard_normal(s, np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _errs(got, want):
    """(max |err|, the largest over query rows of max |err| in the row over
    the row's largest |want|), as chip_smoke.py measures them."""
    d = np.abs(_np(got) - _np(want))
    scale = np.maximum(np.abs(_np(want)).max(-1), 1e-30)
    return float(d.max()), float((d.max(-1) / scale).max())


def tensor_core_emulation(q, k, v, *, causal: bool, window: int,
                          scale: float):
    """The bf16 route of ``csrc/flash_attention.cu`` (flash_mma_kernel) in
    plain PyTorch. q: (BH, Sq, hd), k, v: (BHkv, Skv, hd), bf16. Per
    64-row q tile, the kv tiles of ``fa.tensor_core_tiles`` that the skip
    rule keeps; scores of bf16 q and k summed in f32 and scaled into log2
    units, masked with the finite NEG_INF; online softmax with exp2; p
    enters P V as hi = bf16(p) and lo = bf16(p - hi); O / max(l, 1e-30)
    rounded once to bf16. Rows and keys past the ends are zeros, as the
    kernel's zero-filled tiles are."""
    bh, sq, hd = q.shape
    bhkv, skv, _ = k.shape
    _, bq, bk = fa.tensor_core_tiles(hd)
    g = bh // bhkv
    c = torch.tensor(scale, dtype=torch.float32) \
        * torch.tensor(np.log2(np.e), dtype=torch.float32)
    nk = -(-skv // bk)
    pad = nk * bk - skv
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    kf = kf.repeat_interleave(g, 0)
    vf = vf.repeat_interleave(g, 0)
    out = torch.empty(q.shape, dtype=torch.float32)
    for q0 in range(0, sq, bq):
        qt = q[:, q0:q0 + bq].float()
        qpos = torch.arange(q0, q0 + qt.shape[1])[:, None]
        lo = q0 - window + 1
        kt_begin = lo // bk if window > 0 and lo > 0 else 0
        kt_end = min(nk, (min(q0 + bq, sq) - 1) // bk + 1) if causal else nk
        m = torch.full((bh, qt.shape[1], 1), NEG_INF)
        l = torch.zeros((bh, qt.shape[1], 1))
        acc = torch.zeros_like(qt)
        for kt in range(kt_begin, kt_end):
            k0 = kt * bk
            kpos = torch.arange(k0, k0 + bk)[None, :]
            s = (qt @ kf[:, k0:k0 + bk].transpose(1, 2)) * c
            live = kpos < skv
            if causal:
                live = live & (kpos <= qpos)
            if window > 0:
                live = live & (kpos > qpos - window)
            s = torch.where(live, s, torch.tensor(NEG_INF))
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - mx)
            p = torch.exp2(s - mx)
            l = l * corr + p.sum(-1, keepdim=True)
            m = mx
            hi = p.bfloat16().float()
            lo_ = (p - hi).bfloat16().float()
            vt = vf[:, k0:k0 + bk]
            acc = acc * corr + hi @ vt + lo_ @ vt
        out[:, q0:q0 + bq] = acc / l.clamp_min(1e-30)
    return out.bfloat16()


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
    before = fa.LAUNCHES, dict(fa.ROUTE_LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=True, window=4)
    assert (fa.LAUNCHES, fa.ROUTE_LAUNCHES) == before
    torch.testing.assert_close(
        got, attention_ref(q, k, v, causal=True, window=4, scale=8 ** -0.5),
        rtol=0, atol=0)


@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "x".join(
    str(v) for v in c[:5]) + f"-c{int(c[5])}-w{c[6]}")
def test_tensor_core_emulation_vs_pallas_interpret_and_oracle(case):
    """The tensor-core route's arithmetic within the card's bf16 limits of
    the Pallas kernel (interpret mode) and the JAX oracle, absolute and
    per query row."""
    bh, bhkv, sq, skv, hd, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(
        [(bh, sq, hd), (bhkv, skv, hd), (bhkv, skv, hd)], dtype)
    got = tensor_core_emulation(q, k, v, causal=causal, window=window,
                                scale=hd ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert np.isfinite(_np(got)).all()
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=64, block_k=64, interpret=True)
    oracle = jax_ref.attention_ref(jq, jk, jv, causal=causal, window=window,
                                   scale=hd ** -0.5)
    for want in (pallas, oracle):
        err, row = _errs(got, want)
        assert err <= TOL[dtype] and row <= ROW_RTOL[dtype], (err, row)


def test_tensor_core_emulation_sees_a_window_one_key_short():
    """The planted fault of chip_smoke.py at a window case: the route's
    result against a window one key short fails the limits."""
    bh, bhkv, sq, skv, hd, causal, window, dtype = TC_CASES[-1]
    _, (q, k, v) = _inputs([(bh, sq, hd), (bhkv, skv, hd), (bhkv, skv, hd)],
                           dtype)
    got = tensor_core_emulation(q, k, v, causal=causal, window=window,
                                scale=hd ** -0.5)
    short = attention_ref(q, k, v, causal=causal, window=window - 1,
                          scale=hd ** -0.5)
    err, row = _errs(got, short)
    assert err > TOL[dtype] or row > ROW_RTOL[dtype]


def test_tensor_core_emulation_wipes_a_fully_masked_first_tile():
    """Rows whose first visited kv tile is fully masked (window 300 is no
    multiple of the 32-key tile) average it with p = 1, and the next live
    tile wipes it through corr = 0: the result equals the plain
    version's within one bf16 rounding."""
    bh, sq, hd, window = 2, 512, 256, 300
    _, bq, bk = fa.tensor_core_tiles(hd)
    # rows whose first live key lies past their q tile's first kv tile
    masked_first = [r for r in range(sq)
                    if r - window + 1 >= (max(r // bq * bq - window + 1, 0)
                                          // bk + 1) * bk]
    assert len(masked_first) > 0
    _, (q, k, v) = _inputs([(bh, sq, hd), (1, sq, hd), (1, sq, hd)],
                           "bfloat16", seed=4)
    got = tensor_core_emulation(q, k, v, causal=True, window=window,
                                scale=hd ** -0.5)
    want = attention_ref(q, k, v, causal=True, window=window,
                         scale=hd ** -0.5)
    err, row = _errs(got, want)
    assert err <= TOL["bfloat16"] and row <= ROW_RTOL["bfloat16"]


@pytest.mark.parametrize("hd,tiles", [(1, (64, 64, 64)), (32, (64, 64, 64)),
                                      (64, (64, 64, 64)), (72, (128, 64, 64)),
                                      (128, (128, 64, 64)),
                                      (200, (256, 64, 32)),
                                      (256, (256, 64, 32))])
def test_tensor_core_tiles(hd, tiles):
    assert fa.tensor_core_tiles(hd) == tiles


def test_route_by_dtype():
    """bf16 goes to the tensor-core kernel, f32 to the SIMT one, at every
    head width the kernel takes; nothing else has a route."""
    for hd in (1, 32, 64, 72, 128, 200, 256):
        assert fa.route(torch.bfloat16, hd) == "tensor_core"
        assert fa.route(torch.float32, hd) == "simt"
    assert set(fa.ROUTE_LAUNCHES) == {"tensor_core", "simt"}
    with pytest.raises(ValueError, match="hd <= 256"):
        fa.route(torch.bfloat16, 257)
    with pytest.raises(TypeError, match="no kernel"):
        fa.route(torch.float16, 64)
