"""The CUDA kernels on the card: ``pe_execute`` against its plain version
``select_alu`` bit for bit, and the simulator's card path (sync and async
entry points, patches, a Scheduler drain, a DSE Evaluator, a Fleet and a
fault scenario, a compiled kernel's verify, an autotune and a kernel
graph's drain) against its CPU path; ``flash_attention`` and ``rglru_scan`` against ``attention_ref`` and
``rglru_scan_ref`` within the tolerances of ``tests/test_kernels.py``, and
the LM's kernel path against its plain path. Needs an NVIDIA card
(sm_90a) and nvcc; skipped without a card.

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.dse import Evaluator
from repro_torch.ggpu import isa, programs
from repro_torch.ggpu.engine import (BlockPatch, GGPUConfig, ScalarConfig,
                                     XorBlockPatch, run_kernel,
                                     run_kernel_batch, run_kernel_cohort,
                                     run_kernel_cohort_async)
from repro_torch.ggpu.engine.alu import select_alu
from repro_torch.kernels import pe_simd
from repro_torch.serve import Dep, Scheduler


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
    want = select_alu(args[0], args[2], args[3], args[1])
    before = pe_simd.LAUNCHES
    got = pe_simd.pe_execute(*args)         # L = 100: warps across rows
    assert pe_simd.LAUNCHES == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the same rows at L = 128 (the first 28 lanes again): row-uniform warps
    wide = [torch.cat([x, x[:, :28]], dim=1).contiguous() if x.shape[1] > 1
            else x for x in args]
    got = pe_simd.pe_execute(*wide)
    assert pe_simd.LAUNCHES == before + 2
    torch.testing.assert_close(
        got, select_alu(wide[0], wide[2], wide[3], wide[1]), rtol=0, atol=0)


def _offset(x):
    """``x`` copied to a base one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


# (W, L, base off by one int32): the simulator's L = 64 (the row a shift;
# also off a 16-byte boundary: 4-byte loads need no more), L = 96, the
# scalar 1 x 1 and L no multiple of 32 (the row a division)
@pytest.mark.parametrize("W,L,off", [
    (1, 1, False), (64, 64, False), (1024, 64, False), (37, 5, False),
    (5, 3, False), (9, 96, False), (64, 64, True), (7, 48, True)])
@pytest.mark.parametrize("masked", [False, True])
def test_pe_execute_random_on_card(cuda, W, L, off, masked):
    op, imm, a, b = _inputs(W, L, W * L, cuda)
    if off:
        a, b = _offset(a), _offset(b)
    ops = frozenset({isa.ADD, isa.DIV, isa.SRL, isa.LUI}) if masked else None
    before = pe_simd.LAUNCHES
    got = pe_simd.pe_execute(op, imm, a, b, ops)
    assert pe_simd.LAUNCHES == before + 1
    torch.testing.assert_close(got, select_alu(op, a, b, imm, ops),
                               rtol=0, atol=0)


def test_pe_launch_floor_runs_on_card(cuda):
    op, imm, a, b = _inputs(1024, 64, 0, cuda)
    out = torch.empty_like(a)
    before = pe_simd.LAUNCHES
    pe_simd.launch_floor(op, imm, a, b, out)
    torch.cuda.synchronize()
    assert pe_simd.LAUNCHES == before       # counted nowhere


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


def test_async_handles_and_patches_on_card(cuda):
    """A handle's CUDA event, its final memory in the staged buffer, a
    BlockPatch from a producer's device_mem_block and an XorBlockPatch of
    a card tensor: the card equals the CPU path, and the producer's memory
    is unchanged after its consumer ran."""
    b = programs.build("copy", *programs.SMOKE_SIZES["copy"])
    cfg, n = GGPUConfig(n_cus=2), b.gpu_n
    mems = [b.gpu_mem, b.gpu_mem[::-1].copy()]
    flips = np.arange(2 * n, dtype=np.int32).reshape(2, n) * 977
    out = {}
    for dev in (cuda, torch.device("cpu")):
        hp = run_kernel_cohort_async(b.gpu_prog, mems, b.gpu_items, cfg,
                                     device=dev)
        assert hp.device_mem(0).data_ptr() == hp.staged.data_ptr()
        before = hp.device_mem_block(0, b.gpu_mem.shape[0]).clone()
        hc = run_kernel_cohort_async(
            b.gpu_prog, mems, b.gpu_items, cfg, device=dev,
            patches=BlockPatch(0, n, hp.device_mem_block(n, 2 * n)))
        hx = run_kernel_cohort_async(
            b.gpu_prog, mems, b.gpu_items, cfg, device=dev,
            patches=XorBlockPatch(0, n, torch.from_numpy(flips).to(dev)))
        out[dev.type] = [hp.results(), hc.results(), hx.results()]
        assert hp.ready() and hc.ready() and hx.ready()
        assert torch.equal(hp.device_mem_block(0, b.gpu_mem.shape[0]),
                           before)
    for got, want in zip(out["cuda"], out["cpu"]):
        for (gm, gi), (wm, wi) in zip(got, want):
            np.testing.assert_array_equal(gm, wm)
            assert gi == wi


def test_scheduler_and_evaluator_on_card(cuda):
    """A Scheduler drain (cohort, batch and a Dep chain) and a DSE
    Evaluator on the card equal the same on the CPU."""
    b = programs.build("fir", *programs.SMOKE_SIZES["fir"])
    c = programs.build("copy", *programs.SMOKE_SIZES["copy"])
    cfg = GGPUConfig(n_cus=2)
    got = {}
    for dev in (cuda, "cpu"):
        s = Scheduler(cfg, device=dev, max_inflight=2)
        s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
        s.submit(b.gpu_prog, b.gpu_mem * 3, b.gpu_items)
        t = s.submit(c.gpu_prog, c.gpu_mem, c.gpu_items,
                     out_region=(c.gpu_n, 2 * c.gpu_n))
        s.submit(c.gpu_prog, np.zeros_like(c.gpu_mem), c.gpu_items,
                 deps=[Dep(t, (0, c.gpu_n))])
        ev = Evaluator(benches=("xcorr",), sizes={"xcorr": (16, 32)},
                       device=dev)
        got[str(dev)] = ([(r.mem, r.info) for r in s.drain()],
                         ev.cycles(GGPUConfig(n_cus=2, pipeline_depth=1),
                                   "xcorr")[0])
    (card, card_cycles), (cpu, cpu_cycles) = got["cuda"], got["cpu"]
    assert len(card) == 4 and card_cycles == cpu_cycles
    for (gm, gi), (wm, wi) in zip(card, cpu):
        np.testing.assert_array_equal(gm, wm)
        assert gi == wi


def test_fleet_and_seu_scenario_on_card(cuda):
    """A Fleet drain of a mixed trace over two configs, and the seu fault
    scenario's audited trace, on the card equal the same on the CPU:
    results, reports and the fault decision log."""
    from repro_torch.registry import FAULTS
    from repro_torch.serve import Fleet, Request, result_checksum
    wide = programs.build("copy", 16, 1024)
    narrow = programs.build("reduction", 64, 256)
    rng = np.random.default_rng(1)
    trace = [(x.gpu_prog, rng.integers(-100, 100, x.gpu_mem.shape[0])
              .astype(np.int32), x.gpu_items) for x in (wide, narrow)]
    v = programs.build("vec_mul", 16, 128)
    mems = [rng.integers(-100, 100, v.gpu_mem.shape[0]).astype(np.int32)
            for _ in range(12)]
    audits = [result_checksum(run_kernel(v.gpu_prog, m, v.gpu_items,
                                         GGPUConfig(n_cus=2),
                                         device="cpu")[0]) for m in mems]
    got = {}
    for dev in (cuda, "cpu"):
        fleet = Fleet([("small", GGPUConfig(n_cus=1, freq_mhz=667.0)),
                       ("wide", GGPUConfig(n_cus=8))], device=dev)
        for t in trace:
            fleet.submit(*t)
        out = fleet.drain()
        sc = FAULTS.get("seu")(seed=0, rate=0.5)
        chaos = Fleet([("dev0", GGPUConfig(n_cus=1)),
                       ("dev1", GGPUConfig(n_cus=2))], max_batch=8,
                      device=dev, **sc.fleet_kwargs())
        for m, a in zip(mems, audits):
            chaos.submit_request(Request(v.gpu_prog, m, v.gpu_items,
                                         audit=a))
        served = chaos.drain()
        got[str(dev)] = (out, fleet.report(), served, chaos.report(),
                         sc.decision_log())
    card, cpu = got["cuda"], got["cpu"]
    assert card[1] == cpu[1] and card[3] == cpu[3]
    assert card[4] == cpu[4] and len(card[4]) > 0
    for i in (0, 2):
        assert len(card[i]) == len(cpu[i]) > 0
        for g, w in zip(card[i], cpu[i]):
            np.testing.assert_array_equal(g.mem, w.mem)
            assert {k: g.info[k] for k in w.info if k != "settled_s"} == \
                {k: w.info[k] for k in w.info if k != "settled_s"}


def test_compiled_kernel_verify_on_card(cuda):
    """A compiled kernel's ``verify`` on the card, SIMT and scalar: its
    output equals the oracle and its info equals the CPU path's."""
    from repro_torch.compiler import compile_kernel
    k = compile_kernel(lambda a, b: ((a - b) * a).seg_sum(32),
                       dict(a=512, b=512), name="user_segred")
    ins = k.random_inputs(seed=3)
    for cfg, scalar in ((GGPUConfig(n_cus=2), False),
                        (ScalarConfig(), True)):
        card = k.verify(ins, cfg, scalar=scalar)
        assert card == k.verify(ins, cfg, scalar=scalar, device="cpu")


def test_autotune_on_card_equals_cpu(cuda):
    """One ``autotune`` over SMOKE_SPACE on the card (default device)
    picks the schedule, with the rows, that the CPU path picks."""
    from repro_torch.compiler import SMOKE_SPACE, autotune, kernel_def
    fn, shapes = kernel_def("vec_mul", 512)
    cfg = GGPUConfig(n_cus=2)
    card = autotune(fn, shapes, cfg, space=SMOKE_SPACE, name="vm_card")
    cpu = autotune(fn, shapes, cfg, space=SMOKE_SPACE, name="vm_card",
                   device="cpu")
    assert card.report() == cpu.report()
    assert card.best_schedule.label() == "c2"


def test_submit_programs_drain_on_card_equals_cpu(cuda):
    """A stage-major drain of a 3-stage graph on the card: one dispatch
    a stage, outputs and infos equal the CPU path's and the oracle."""
    from repro_torch.compiler import compile_graph
    from repro_torch.serve import extract_outputs, submit_programs
    prog = compile_graph(lambda a, b: (a * b).seg_sum(64) * 3 + 1,
                         {"a": 256, "b": 256}, name="map_reduce_scale")
    rng = np.random.default_rng(7)
    ins = [{"a": rng.integers(-100, 100, 256).astype(np.int32),
            "b": rng.integers(-100, 100, 256).astype(np.int32)}
           for _ in range(8)]
    got = {}
    for dev in (cuda, "cpu"):
        s = Scheduler(GGPUConfig(n_cus=2), max_batch=8, device=dev)
        d0 = s.executor.stats.dispatches
        handles = submit_programs(s, prog, ins)
        results = s.drain()
        assert s.executor.stats.dispatches - d0 == 3
        got[str(dev)] = (extract_outputs(results, handles),
                         [r.info for r in results])
    (card, card_infos), (cpu, cpu_infos) = got["cuda"], got["cpu"]
    for g, w, i in zip(card, cpu, ins):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, prog.reference(i))
    strip = lambda d: {k: v for k, v in d.items() if k != "settled_s"}  # noqa
    assert [strip(i) for i in card_infos] == [strip(i) for i in cpu_infos]


# ---------------------------------------------------------------------------
# the LM kernels: flash_attention and rglru_scan against their plain
# versions on the card
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels.ref import attention_ref, rglru_scan_ref  # noqa: E402

# (bh, bhkv, sq, skv, hd, causal, window, dtype): the shapes of
# tests/test_kernels.py, the SmolLM-360M shape (15 q / 5 kv heads, hd 64),
# RecurrentGemma-2B's prefill (4 x 10 q heads, 1 kv head, hd 256) and the
# bf16 (tensor-core) route's edges: hd no multiple of 16, a window no
# multiple of the kv tile, cross lengths, hd no multiple of 8 (plain
# loads in place of 16-byte cp.async)
FLASH_CASES = [
    (4, 2, 256, 256, 64, True, 0, torch.float32),
    (4, 4, 128, 128, 32, False, 0, torch.float32),
    (8, 2, 200, 200, 64, True, 64, torch.float32),
    (2, 1, 384, 384, 128, True, 128, torch.float32),
    (2, 2, 128, 128, 64, True, 0, torch.bfloat16),
    (6, 3, 96, 160, 64, False, 0, torch.float32),
    (15, 5, 333, 333, 64, True, 0, torch.bfloat16),
    (40, 4, 3072, 3072, 256, True, 2048, torch.bfloat16),
    (8, 2, 200, 200, 72, True, 64, torch.bfloat16),
    (10, 1, 1000, 1000, 256, True, 300, torch.bfloat16),
    (6, 3, 96, 160, 64, False, 0, torch.bfloat16),
    (3, 1, 130, 130, 33, True, 0, torch.bfloat16),
]


@pytest.fixture
def exact_matmul(cuda):
    """Full-precision references: no TF32, no reduced bf16 reductions."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = saved


def _normal(shape, seed, dtype, dev):
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return torch.as_tensor(x, device=dev).to(dtype)


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(
    str(v) for v in c[:5]) + f"-c{int(c[5])}-w{c[6]}-{str(c[7])[6:]}")
def test_flash_attention_on_card(cuda, exact_matmul, case):
    bh, bhkv, sq, skv, hd, causal, window, dtype = case
    q = _normal((bh, sq, hd), 1, dtype, cuda)
    k = _normal((bhkv, skv, hd), 2, dtype, cuda)
    v = _normal((bhkv, skv, hd), 3, dtype, cuda)
    before = fa.LAUNCHES
    route = "tensor_core" if dtype == torch.bfloat16 else "simt"
    before_route = fa.ROUTE_LAUNCHES[route]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == before + 1
    assert fa.ROUTE_LAUNCHES[route] == before_route + 1
    want = attention_ref(q, k, v, causal=causal, window=window,
                         scale=hd ** -0.5)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5     # tests/test_kernels.py
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    # per query row, over the row's largest |o| (chip_smoke.py's limit):
    # one bf16 rounding is at most 2**-7 of it
    row_rtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    d = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    assert float((d / scale).max()) <= row_rtol


@pytest.mark.parametrize("hd", [32, 64, 72, 128, 256])
def test_flash_attention_tensor_core_design_on_card(cuda, hd):
    """The built tensor-core kernel has the tiles its Python mirror states
    and fits on an SM without spilling registers."""
    design = fa.tensor_core_design(hd)
    assert (design["hd_pad"], design["block_q"], design["block_k"]) \
        == fa.tensor_core_tiles(hd)
    assert design["stages"] == 2 and design["blocks_per_sm"] >= 1
    assert design["spill_bytes"] == 0


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((2, 8, 512), device=cuda)
    with pytest.raises(ValueError, match="hd <= 256"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())


# (B, S, D, base off by one float, route): the path's two prefill waves,
# the test shapes, a ragged channel tile (D = 40), S = 1, a ragged last
# stage over several turns of the ring; D no multiple of 4 and a base off
# by one float on the direct route
@pytest.mark.parametrize("b,s,d,off,path", [
    (1, 64, 128, False, "ring"), (3, 100, 96, False, "ring"),
    (2, 17, 40, False, "ring"), (4, 3072, 2560, False, "ring"),
    (2, 600, 2560, False, "ring"), (1, 1, 64, False, "ring"),
    (2, 1000, 64, False, "ring"), (2, 17, 33, False, "direct"),
    (2, 100, 64, True, "direct")])
def test_rglru_scan_on_card(cuda, b, s, d, off, path):
    g = np.random.default_rng(s)
    a = torch.sigmoid(torch.as_tensor(g.standard_normal((b, s, d),
                                                        np.float32),
                                      device=cuda))
    x = torch.as_tensor(g.standard_normal((b, s, d), np.float32), device=cuda)
    h0 = torch.as_tensor(g.standard_normal((b, d), np.float32), device=cuda)
    if off:
        a, x = _offset(a), _offset(x)
    before = rg.LAUNCHES, dict(rg.ROUTE_LAUNCHES)
    h, hf = rg.rglru_scan(a, x, h0)
    assert rg.LAUNCHES == before[0] + 1
    assert {r: n - before[1][r] for r, n in rg.ROUTE_LAUNCHES.items()} \
        == {r: int(r == path) for r in rg.ROUTES}
    hr, hfr = rglru_scan_ref(a, x, h0)
    torch.testing.assert_close(h, hr, rtol=0, atol=1e-5)
    torch.testing.assert_close(hf, hfr, rtol=0, atol=1e-5)
    if path == "ring":                # the direct route on the same inputs
        hd, hfd = rg._launch("direct", a, x, h0)
        torch.testing.assert_close(hd, hr, rtol=0, atol=1e-5)
        torch.testing.assert_close(hfd, hfr, rtol=0, atol=1e-5)


def test_rglru_ring_design_on_card(cuda):
    """The built ring kernel: a warp on 32 channels, its ring of a and b
    in shared memory with one 8-byte mbarrier a stage, three blocks on an
    SM (the path's 320 blocks all resident on 132 SMs), no spills."""
    d = rg.ring_design()
    assert d["tile"] == 32
    assert d["smem_bytes"] == 2 * d["stages"] * d["steps"] * d["tile"] * 4 \
        + 8 * d["stages"]
    assert d["blocks_per_sm"] >= 3 and d["spill_bytes"] == 0


def test_rglru_ring_route_refuses_what_it_does_not_take(cuda):
    """The ring's C entry refuses a base off 16 bytes or D no multiple of
    4, which the wrapper sends to the direct route."""
    a = torch.rand((1, 8, 36), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        rg._launch("ring", _offset(a), a, a[:, 0].contiguous())
    a = torch.rand((1, 8, 30), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        rg._launch("ring", a, a, a[:, 0].contiguous())


@pytest.mark.parametrize("s,b", [(2, 1), (7, 3), (30, 2)])
def test_rglru_scan_split_and_carry_on_card(cuda, s, b):
    g = np.random.default_rng(s * 7 + b)
    d = 16
    a = torch.sigmoid(torch.as_tensor(g.standard_normal((b, s, d),
                                                        np.float32),
                                      device=cuda))
    x = torch.as_tensor(g.standard_normal((b, s, d), np.float32), device=cuda)
    h0 = torch.as_tensor(g.standard_normal((b, d), np.float32), device=cuda)
    cut = max(1, s // 2)
    h_full, hf_full = rglru_scan_ref(a, x, h0)
    _, hf1 = rg.rglru_scan(a[:, :cut].contiguous(), x[:, :cut].contiguous(),
                           h0)
    h2, hf2 = rg.rglru_scan(a[:, cut:].contiguous(), x[:, cut:].contiguous(),
                            hf1)
    torch.testing.assert_close(hf2, hf_full, rtol=0, atol=1e-4)
    torch.testing.assert_close(h2, h_full[:, cut:], rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "smollm-360m"])
def test_lm_kernel_path_equals_plain_path_on_card(cuda, exact_matmul, arch):
    """The SMOKE model at f32 on the card: prefill through the kernels
    against the plain path, and the same greedy tokens."""
    from repro_torch.configs import get_smoke
    from repro_torch.convert import init_model
    from repro_torch.models import model as M
    from repro_torch.serve.llm import Engine, EngineConfig
    cfg = get_smoke(arch).replace(compute_dtype="float32", use_kernels=True)
    model = init_model(cfg, 0)
    g = np.random.default_rng(0)
    tokens = torch.as_tensor(g.integers(0, cfg.vocab_size, (3, 40)),
                             device=cuda)
    before = (fa.LAUNCHES, rg.LAUNCHES)
    got, _ = M.prefill(model, cfg, tokens=tokens)
    n_attn = sum(k != "rglru" for k in cfg.pattern())
    assert (fa.LAUNCHES - before[0], rg.LAUNCHES - before[1]) == (
        n_attn, cfg.n_layers - n_attn)
    plain = cfg.replace(use_kernels=False)
    want, _ = M.prefill(model, plain, tokens=tokens)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    prompts = [list(map(int, g.integers(0, cfg.vocab_size, n)))
               for n in (30, 5, 17)]
    assert Engine(cfg, model, EngineConfig(slots=2)).generate(prompts, 6) \
        == Engine(plain, model, EngineConfig(slots=2)).generate(prompts, 6)
