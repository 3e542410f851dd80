"""The routes of the port's CUDA kernels and the ring's walk, on the CPU.

``rglru_scan`` chooses a kernel route from shape and alignment alone
(``rglru_scan.scan_route``); ``pe_execute`` has one kernel for every
shape. Here, without a card:

  * the scan's route at the main path's shapes and at the edges (ragged
    channel tile, D no multiple of 4, a base off by one float, S = 1,
    S = 0);
  * a plain-PyTorch replay of the ring route's walk (per channel tile, a
    ring of stages of the sizes csrc/rglru_scan.cu builds, filled the way
    the tensor map fills them, zeros past the edges, the walk stopping at
    S) held at 1e-5 against the Pallas kernel in interpret mode and the
    JAX oracle, as tests/test_torch_rglru.py holds the port's plain
    version;
  * ``pe_execute``'s CPU route bit for bit against the Pallas kernel in
    interpret mode (and the JAX ``select_alu`` where opcodes are pruned)
    at every (W, L) the simulator's main path launches it at, and at L
    no multiple of 32.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ggpu.engine import alu as jax_alu
from repro.kernels import ref as jax_ref
from repro.kernels.pe_simd import pe_execute as jax_pe_execute
from repro.kernels.rglru_scan import rglru_scan as jax_rglru
from repro_torch.ggpu import isa
from repro_torch.kernels import pe_simd
from repro_torch.kernels import rglru_scan as rg

CSRC = Path(rg.__file__).parent / "csrc"


def _constants(source: str) -> dict:
    text = (CSRC / source).read_text()
    return {m[1]: int(m[2]) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


# -- rglru_scan ---------------------------------------------------------------

# (B, S, D, aligned, route): the path's prefill waves, the ragged channel
# tile, D no multiple of 4, a base off by one float, S = 1, S = 0
SCAN_CASES = [
    ((4, 3072, 2560), True, "ring"),
    ((2, 600, 2560), True, "ring"),
    ((2, 17, 40), True, "ring"),
    ((1, 1, 64), True, "ring"),
    ((1, 130, 16), True, "ring"),
    ((2, 17, 33), True, "direct"),
    ((4, 3072, 2560), False, "direct"),
    ((3, 0, 64), True, "direct"),
]


@pytest.mark.parametrize("shape,aligned,want", SCAN_CASES,
                         ids=lambda c: str(c))
def test_scan_route(shape, aligned, want):
    assert rg.scan_route(*shape, aligned) == want


def ring_replay(a, b, h0):
    """The ring route's walk in plain PyTorch: per block (one batch row,
    one tile of channels) a ring of ``stages`` slots, each filled with a
    (steps, tile) box of a and of b that reads zeros past S and D, walked
    step by step with h = a * h + b until S, h stored only for channels
    below D. Returns (h, h_final, how often each element was written)."""
    B, S, D = a.shape
    assert rg.scan_route(B, S, D, aligned=True) == "ring"
    c = _constants("rglru_scan.cu")
    tile, steps, stages = c["kTile"], c["kSteps"], c["kStages"]
    tiles = -(-D // tile)
    n_stages = -(-S // steps)
    h = torch.full_like(a, float("nan"))
    h_final = torch.full_like(h0, float("nan"))
    written = torch.zeros(a.shape, dtype=torch.int64)
    for blk in range(B * tiles):
        bi, t = divmod(blk, tiles)
        d0 = t * tile
        ch = d0 + torch.arange(tile)
        live = ch < D
        ring = [None] * stages

        def fill(k):
            box_a = torch.zeros(steps, tile)
            box_b = torch.zeros(steps, tile)
            s0 = k * steps
            ns, nd = min(S, s0 + steps) - s0, min(D, d0 + tile) - d0
            box_a[:ns, :nd] = a[bi, s0:s0 + ns, d0:d0 + nd]
            box_b[:ns, :nd] = b[bi, s0:s0 + ns, d0:d0 + nd]
            ring[k % stages] = (k, box_a, box_b)

        for k in range(min(stages, n_stages)):
            fill(k)
        hv = torch.where(live, h0[bi, ch.clamp(max=D - 1)],
                         torch.zeros(tile))
        for k in range(n_stages):
            got, sa, sb = ring[k % stages]
            assert got == k               # the slot holds stage k
            for u in range(min(steps, S - k * steps)):
                hv = sa[u] * hv + sb[u]
                h[bi, k * steps + u, ch[live]] = hv[live]
                written[bi, k * steps + u, ch[live]] += 1
            if k + stages < n_stages:
                fill(k + stages)
        h_final[bi, ch[live]] = hv[live]
    return h, h_final, written


# ragged channel tile and ragged last stage; whole stages; S = 1; several
# stages with the ring wrapping round
@pytest.mark.parametrize("b,s,d", [(2, 17, 40), (1, 128, 64), (1, 1, 8),
                                   (1, 300, 36)])
def test_ring_replay_vs_pallas_interpret_and_oracle(b, s, d):
    g = np.random.default_rng(s + d)
    a = (1.0 / (1.0 + np.exp(-g.standard_normal((b, s, d))))).astype(
        np.float32)
    x = g.standard_normal((b, s, d)).astype(np.float32)
    h0 = g.standard_normal((b, d)).astype(np.float32)
    h, hf, written = ring_replay(*map(torch.from_numpy, (a, x, h0)))
    assert (written == 1).all()
    ph, phf = jax_rglru(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0),
                        block_d=64, chunk=16, interpret=True)
    rh, rhf = jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(x),
                                     jnp.asarray(h0))
    for got, want in ((h, ph), (hf, phf), (h, rh), (hf, rhf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- pe_execute ---------------------------------------------------------------

# (W, L): the simulator's main-path shapes (64 and 32 wavefronts of 64
# lanes, the scalar baseline's 1 x 1, 8 wavefronts, vec_mul's 1024 and 512
# on one CU, 3072 in the batch of three), L no multiple of 32
PE_SHAPES = [(64, 64), (32, 64), (1, 1), (8, 64), (1024, 64), (512, 64),
             (3072, 64), (37, 5), (5, 48), (3, 96)]
PRUNED = frozenset({isa.ADD, isa.MUL, isa.DIV, isa.SRL, isa.LUI})


@pytest.mark.parametrize("W,L", PE_SHAPES, ids=lambda c: str(c))
@pytest.mark.parametrize("ops", [None, PRUNED], ids=["all", "pruned"])
def test_pe_execute_cpu_route_at_path_shapes(W, L, ops):
    g = np.random.default_rng(W * 100 + L)
    op, imm, a, b = (g.integers(lo, hi, shape).astype(np.int32)
                     for lo, hi, shape in
                     ((0, isa.N_OPS, (W, 1)), (-2**31, 2**31, (W, 1)),
                      (-2**31, 2**31, (W, L)), (-2**31, 2**31, (W, L))))
    before = pe_simd.LAUNCHES
    got = pe_simd.pe_execute(*map(torch.from_numpy, (op, imm, a, b)),
                             ops).numpy()
    assert pe_simd.LAUNCHES == before      # the CPU route launches nothing
    if ops is None:
        want = jax_pe_execute(*map(jnp.asarray, (op, imm, a, b)),
                              interpret=True)
    else:
        want = jax_alu.select_alu(*map(jnp.asarray, (op, a, b, imm)), ops)
    np.testing.assert_array_equal(got, np.asarray(want))
