"""The CUDA kernel on the card: ``pe_execute`` against its plain version
``select_alu`` bit for bit, and the simulator's card path against its CPU
path. Needs an NVIDIA card (sm_90a) and nvcc; skipped without a card.

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.ggpu import isa, programs
from repro_torch.ggpu.engine import (GGPUConfig, ScalarConfig, run_kernel,
                                     run_kernel_batch, run_kernel_cohort)
from repro_torch.ggpu.engine.alu import select_alu
from repro_torch.kernels import pe_simd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


pytestmark = [pytest.mark.requires_cuda, pytest.mark.usefixtures("cuda")]

EDGES = np.array([-2**31, 2**31 - 1, -1, 0, 1, 31, 32, -7, 65536, 2**20],
                 np.int64)


def _inputs(W, L, seed, dev):
    g = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x.astype(np.int32), device=dev)  # noqa
    return (t(g.integers(0, isa.N_OPS, (W, 1))),
            t(g.integers(-2**31, 2**31, (W, 1))),
            t(g.integers(-2**31, 2**31, (W, L))),
            t(g.integers(-2**31, 2**31, (W, L))))


def test_pe_execute_edges_on_card(cuda):
    a, b = np.meshgrid(EDGES, EDGES, indexing="ij")
    op = np.repeat(np.arange(isa.N_OPS), EDGES.size)[:, None]
    imm = np.tile(EDGES, isa.N_OPS)[:, None]
    W = op.shape[0]
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x).astype(np.int32),  # noqa
                                  device=cuda)
    args = (t(op), t(imm), t(np.broadcast_to(a.reshape(-1), (W, a.size))),
            t(np.broadcast_to(b.reshape(-1), (W, b.size))))
    before = pe_simd.LAUNCHES
    got = pe_simd.pe_execute(*args)
    assert pe_simd.LAUNCHES == before + 1
    torch.testing.assert_close(got, select_alu(args[0], args[2], args[3],
                                               args[1]), rtol=0, atol=0)


@pytest.mark.parametrize("W,L", [(1, 1), (64, 64), (1024, 64), (37, 5)])
@pytest.mark.parametrize("masked", [False, True])
def test_pe_execute_random_on_card(cuda, W, L, masked):
    op, imm, a, b = _inputs(W, L, W * L, cuda)
    ops = frozenset({isa.ADD, isa.DIV, isa.SRL, isa.LUI}) if masked else None
    got = pe_simd.pe_execute(op, imm, a, b, ops)
    torch.testing.assert_close(got, select_alu(op, a, b, imm, ops),
                               rtol=0, atol=0)


def test_simulator_card_path_equals_cpu_path(cuda):
    for name in ("fir", "xcorr", "div_int"):
        b = programs.build(name, *programs.SMOKE_SIZES[name])
        for cfg, args in ((GGPUConfig(n_cus=2),
                           (b.gpu_prog, b.gpu_mem, b.gpu_items)),
                          (ScalarConfig(), (b.scalar_prog, b.scalar_mem, 1))):
            before = pe_simd.LAUNCHES
            mem, info = run_kernel(*args, cfg)
            assert pe_simd.LAUNCHES - before >= info["steps"]
            mem_c, info_c = run_kernel(*args, cfg, device="cpu")
            np.testing.assert_array_equal(mem, mem_c)
            assert info == info_c


def test_folded_entry_points_on_card(cuda):
    b = programs.build("fir", *programs.SMOKE_SIZES["fir"])
    cfg = GGPUConfig(n_cus=2)
    mems = [b.gpu_mem, b.gpu_mem[::-1].copy(), b.gpu_mem * 2]
    for got, want in zip(run_kernel_cohort(b.gpu_prog, mems, b.gpu_items,
                                           cfg),
                         run_kernel_cohort(b.gpu_prog, mems, b.gpu_items,
                                           cfg, device="cpu")):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    c = programs.build("copy", *programs.SMOKE_SIZES["copy"])
    args = ([b.gpu_prog, c.gpu_prog], [b.gpu_mem, c.gpu_mem],
            [b.gpu_items, c.gpu_items])
    for got, want in zip(run_kernel_batch(*args, cfg),
                         run_kernel_batch(*args, cfg, device="cpu")):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
