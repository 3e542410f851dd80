"""The port's async entry points against the JAX package's, exactly
(tests/test_async.py on the port, ``device="cpu"``): ``LaunchHandle``s of
the single, cohort and batch paths and pipelined scheduler drains equal
the reference's launches on all 8 benches; ``out_region`` slices; the
staged buffer holding the final memory (the port's analogue of
donation); failures through the handle; the frequency-faithful executor
registry, keyed by device; patches, which copy from a producer's final
memory and never write it."""
import numpy as np
import pytest
import torch
from test_torch_parity import (check_launch, pad_prog, small_benches,
                               spinner, variant_mem)

from repro.ggpu.engine import BlockPatch as JaxBlockPatch
from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.ggpu.engine import KernelLaunchError as JaxLaunchError
from repro.ggpu.engine import XorBlockPatch as JaxXorBlockPatch
from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro.ggpu.engine import run_kernel_async as jax_single_async
from repro.ggpu.engine import run_kernel_batch_async as jax_batch_async
from repro.ggpu.engine import run_kernel_cohort_async as jax_cohort_async
from repro.serve import Scheduler as JaxScheduler
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import (BlockPatch, GGPUConfig,
                                     KernelLaunchError, XorBlockPatch,
                                     run_kernel, run_kernel_async,
                                     run_kernel_batch,
                                     run_kernel_batch_async,
                                     run_kernel_cohort,
                                     run_kernel_cohort_async)
from repro_torch.ggpu.engine.stepper import _static_ops
from repro_torch.serve import Request, Scheduler, get_executor, sim_key

CFG = GGPUConfig(n_cus=2)
JCFG = JaxConfig(n_cus=2)
CPU = "cpu"
SMALL = small_benches()


@pytest.mark.parametrize("name", sorted(SMALL))
def test_async_bitexact_all_paths_and_interleaved_drain(name):
    """Handles from all three async entry points, and a pipelined
    scheduler drain interleaved under a budget, return the JAX package's
    bits (mem, cycles, stats) of each launch on every bench. (A program
    padded with HALT rows behaves as the unpadded one: the reference runs
    the unpadded program once per image.)"""
    b = SMALL[name]()
    progA = b.gpu_prog
    progB = pad_prog(progA, 1)
    progC = pad_prog(progA, 2)
    m0, m1, m2 = b.gpu_mem, variant_mem(b, 1), variant_mem(b, 2)
    launches = [(progB, m1), (progA, m0), (progA, m2), (progC, m0)]
    ref = {k: jax_run_kernel(progA, m, b.gpu_items, JCFG)
           for k, m in ((1, m1), (0, m0), (2, m2))}
    direct = [ref[1], ref[0], ref[2], ref[0]]

    h = run_kernel_async(progA, m0, b.gpu_items, CFG, device=CPU)
    assert h.ready()
    mem, info = h.result()
    check_launch((mem, info), direct[1])
    assert "batch_size" not in info
    hc = run_kernel_cohort_async(progA, [m0, m2], b.gpu_items, CFG,
                                 device=CPU)
    for out, d in zip(hc.results(), (direct[1], direct[2])):
        check_launch(out, d)
        assert out[1]["batch_size"] == 2
    hb = run_kernel_batch_async([progB, progC], [m1, m0],
                                [b.gpu_items, b.gpu_items], CFG, device=CPU)
    for out, d in zip(hb.results(), (direct[0], direct[3])):
        check_launch(out, d)

    s = Scheduler(CFG, max_inflight=2, device=CPU)
    for p, m in launches:
        s.submit(p, m, b.gpu_items)
    out = s.drain(budget=1)
    out += s.drain()
    assert len(s) == 0 and not s.quarantined
    got = {r.info["ticket"]: r for r in out}
    assert sorted(got) == [0, 1, 2, 3]
    for t, d in enumerate(direct):
        check_launch(got[t], d)


def test_out_region_sliced_download():
    """A declared out_region downloads exactly that slice of the final
    image — on every path, through the scheduler too — and (0, 0)
    transfers nothing while cycles stay exact."""
    b = SMALL["vec_mul"]()
    lo, hi = b.gpu_out.start, b.gpu_out.stop
    full, dinfo = jax_run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items, JCFG)
    full = np.asarray(full)

    h = run_kernel_async(b.gpu_prog, b.gpu_mem, b.gpu_items, CFG,
                         out_region=(lo, hi), device=CPU)
    mem, info = h.result()
    np.testing.assert_array_equal(mem, full[lo:hi])
    assert info["cycles"] == dinfo["cycles"]

    m2 = variant_mem(b, 5)
    full2 = np.asarray(jax_run_kernel(b.gpu_prog, m2, b.gpu_items, JCFG)[0])
    hc = run_kernel_cohort_async(b.gpu_prog, [b.gpu_mem, m2], b.gpu_items,
                                 CFG, out_regions=[(lo, hi), None],
                                 device=CPU)
    outs = hc.results()
    np.testing.assert_array_equal(outs[0][0], full[lo:hi])
    np.testing.assert_array_equal(outs[1][0], full2)

    hb = run_kernel_batch_async(
        [b.gpu_prog, pad_prog(b.gpu_prog, 1)], [b.gpu_mem, m2],
        [b.gpu_items] * 2, CFG, out_regions=[(lo, hi), (0, 0)], device=CPU)
    outs = hb.results()
    np.testing.assert_array_equal(outs[0][0], full[lo:hi])
    assert outs[1][0].shape == (0,)
    assert outs[1][1]["cycles"] == dinfo["cycles"]

    # one uniform region: one slice of the whole chunk, every launch's row
    hu = run_kernel_cohort_async(b.gpu_prog, [b.gpu_mem, m2], b.gpu_items,
                                 CFG, out_regions=[(lo, hi)] * 2, device=CPU)
    np.testing.assert_array_equal(hu.mem(1), full2[lo:hi])
    np.testing.assert_array_equal(hu.mem(0), full[lo:hi])

    s = Scheduler(CFG, device=CPU)
    s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items, out_region=(lo, hi))
    s.submit(b.gpu_prog, m2, b.gpu_items, out_region=(0, 0))
    r0, r1 = s.drain()
    np.testing.assert_array_equal(r0.mem, full[lo:hi])
    assert r1.mem.shape == (0,) and r1.info["cycles"] == dinfo["cycles"]

    with pytest.raises(ValueError):
        run_kernel_async(b.gpu_prog, b.gpu_mem, b.gpu_items, CFG,
                         out_region=(0, b.gpu_mem.shape[0] + 1), device=CPU)
    with pytest.raises(ValueError):
        run_kernel_cohort_async(b.gpu_prog, [b.gpu_mem], b.gpu_items, CFG,
                                out_regions=[None, None], device=CPU)


def test_staged_buffer_holds_the_final_memory():
    """The reference donates its staged buffer (tests/test_async.py
    asserts ``donated.is_deleted()``); the port's machine updates it in
    place, so the handle's final memory *is* the staged buffer, while the
    caller's host array is never touched and dispatches again cleanly."""
    b = SMALL["copy"]()
    before = b.gpu_mem.copy()
    h = run_kernel_async(b.gpu_prog, b.gpu_mem, b.gpu_items, CFG,
                         device=CPU)
    assert h.device_mem(0).data_ptr() == h.staged.data_ptr()
    np.testing.assert_array_equal(h.staged[:-1].numpy(), h.result()[0])
    np.testing.assert_array_equal(b.gpu_mem, before)
    np.testing.assert_array_equal(h.result()[0][b.gpu_out],
                                  b.ref(b.gpu_mem, b.gpu_n))
    for hf in (run_kernel_cohort_async(b.gpu_prog, [b.gpu_mem, b.gpu_mem],
                                       b.gpu_items, CFG, device=CPU),
               run_kernel_batch_async([b.gpu_prog, pad_prog(b.gpu_prog, 1)],
                                      [b.gpu_mem, b.gpu_mem],
                                      [b.gpu_items] * 2, CFG, device=CPU)):
        assert hf.device_mem_block(0, 4).data_ptr() == hf.staged.data_ptr()
        assert hf.device_mem(1).data_ptr() == \
            hf.staged.data_ptr() + 4 * b.gpu_mem.shape[0]
    np.testing.assert_array_equal(b.gpu_mem, before)
    check_launch(run_kernel_async(b.gpu_prog, b.gpu_mem, b.gpu_items, CFG,
                                  device=CPU).result(),
                 run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items, CFG,
                            device=CPU))


def test_launch_handle_surfaces_failure():
    """A launch that hits max_steps raises out of the handle at
    resolution, naming the reference's failing position, again on every
    call — on every path."""
    cfg = GGPUConfig(max_steps=50)
    b = programs._copy(8, 64)
    h = run_kernel_async(spinner(), np.zeros(8, np.int32), 8, cfg,
                         device=CPU)
    assert h.ready()
    with pytest.raises(KernelLaunchError) as exc:
        h.result()
    assert exc.value.index == 0
    with pytest.raises(KernelLaunchError):
        h.wait()
    hc = run_kernel_cohort_async(spinner(), [np.zeros(8, np.int32)] * 2, 8,
                                 cfg, device=CPU)
    with pytest.raises(KernelLaunchError):
        hc.results()
    progs = [b.gpu_prog, spinner()]
    mems = [b.gpu_mem, np.zeros(8, np.int32)]
    hb = run_kernel_batch_async(progs, mems, [b.gpu_items, 8], cfg,
                                device=CPU)
    with pytest.raises(KernelLaunchError) as exc:
        hb.results()
    with pytest.raises(JaxLaunchError) as jexc:
        jax_batch_async(progs, mems, [b.gpu_items, 8],
                        JaxConfig(max_steps=50)).results()
    assert exc.value.index == jexc.value.index == 1


@pytest.mark.parametrize("max_inflight", (1, 8))
def test_pipelined_drain_quarantines_at_any_depth(max_inflight):
    """Pipeline depth changes neither results nor quarantine: a poisoned
    launch is isolated, survivors equal the reference's, and the
    executor's counters equal the JAX scheduler's on the same traffic."""
    b = programs._copy(16, 128)
    c2 = programs._copy(8, 64)               # W=1: shares spinner's bucket
    traffic = [(b.gpu_prog, b.gpu_mem, b.gpu_items),
               (spinner(), np.zeros(8, np.int32), 8),
               (c2.gpu_prog, c2.gpu_mem, c2.gpu_items),
               (b.gpu_prog, variant_mem(b, 3), b.gpu_items)]
    s = Scheduler(GGPUConfig(max_steps=50), max_inflight=max_inflight,
                  device=CPU)
    js = JaxScheduler(JaxConfig(max_steps=50), max_inflight=max_inflight)
    for args in traffic:
        s.submit(*args)
        js.submit(*args)
    results, want = s.drain(), js.drain()
    assert len(s) == 0
    assert [r.info["ticket"] for r in results] == \
        [r.info["ticket"] for r in want] == [0, 2, 3]
    assert set(s.quarantined) == set(js.quarantined) == {1}
    for got, ref in zip(results, want):
        check_launch(got, ref)
        assert got.info == ref.info
    assert s.executor.stats.report() == js.executor.stats.report()


def test_registry_is_frequency_faithful_and_keyed_by_device(monkeypatch):
    """get_executor at a non-default frequency returns a view sharing the
    canonical executor's envelope cache, stats and memo, reporting
    time_us at the true freq_mhz; the registry's key holds the device, so
    one device's memo never answers another's query, and without a card
    the default device raises instead of running on the CPU."""
    cfg667 = GGPUConfig(n_cus=4, freq_mhz=667.0)
    ex = get_executor(cfg667, device=CPU)
    assert ex.cfg.freq_mhz == 667.0 and ex.sim_cfg == sim_key(cfg667)
    canon = get_executor(sim_key(cfg667), device=CPU)
    assert canon is not ex
    assert ex.memo is canon.memo and ex.stats is canon.stats
    assert ex._envelopes is canon._envelopes
    assert get_executor(cfg667, device=CPU) is ex
    other = get_executor(cfg667, device="meta")
    assert other.memo is not ex.memo and other.stats is not ex.stats
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_executor(cfg667)

    b = SMALL["copy"]()
    (res,) = ex.run("single", [Request(b.gpu_prog, b.gpu_mem, b.gpu_items)])
    assert res.info["time_us"] == pytest.approx(res.info["cycles"] / 667.0)
    hits = canon.stats.trace_hits
    (res500,) = canon.run("single",
                          [Request(b.gpu_prog, b.gpu_mem, b.gpu_items)])
    assert res500.info["cycles"] == res.info["cycles"]
    assert res500.info["time_us"] == pytest.approx(
        res.info["cycles"] / 500.0)
    assert canon.stats.trace_hits == hits + 1


def test_bad_out_region_bounces_at_admission():
    b = SMALL["copy"]()
    s = Scheduler(CFG, device=CPU)
    with pytest.raises(ValueError):
        s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                 out_region=(0, b.gpu_mem.shape[0] + 1))
    with pytest.raises(ValueError):
        s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items, out_region=(-1, 0))
    assert len(s) == 0
    s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    assert len(s.drain()) == 1


def test_trace_hits_counted_across_pipeline_window():
    """Identical envelopes dispatched ahead in one window are hits: the
    counters equal the JAX scheduler's (one miss, three hits)."""
    b = SMALL["vec_mul"]()
    s = Scheduler(CFG, max_batch=2, max_inflight=8, device=CPU)
    js = JaxScheduler(JCFG, max_batch=2, max_inflight=8)
    for seed in range(8):
        s.submit(b.gpu_prog, variant_mem(b, seed), b.gpu_items)
        js.submit(b.gpu_prog, variant_mem(b, seed), b.gpu_items)
    out, want = s.drain(), js.drain()
    assert len(out) == 8
    for got, ref in zip(out, want):
        check_launch(got, ref)
    st = s.executor.stats
    assert st.dispatches == 4 and st.trace_misses == 1 and st.trace_hits == 3
    assert st.report() == js.executor.stats.report()


def test_sync_entries_accept_iterators():
    b = SMALL["copy"]()
    direct = jax_run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items, JCFG)
    outs = run_kernel_cohort(b.gpu_prog,
                             (m for m in [b.gpu_mem, variant_mem(b, 1)]),
                             b.gpu_items, CFG, device=CPU)
    assert len(outs) == 2
    check_launch(outs[0], direct)
    assert run_kernel_cohort(b.gpu_prog, iter([]), b.gpu_items, CFG,
                             device=CPU) == []
    outs = run_kernel_batch((p for p in [b.gpu_prog]),
                            (m for m in [b.gpu_mem]),
                            (n for n in [b.gpu_items]), CFG, device=CPU)
    check_launch(outs[0], direct)
    assert run_kernel_batch(iter([]), iter([]), iter([]), CFG,
                            device=CPU) == []


def test_request_static_ops_content_cached():
    b = SMALL["fir"]()
    r1 = Request(b.gpu_prog, b.gpu_mem, b.gpu_items)
    r2 = Request(b.gpu_prog.copy(), variant_mem(b, 1), b.gpu_items)
    assert r1.static_ops() == _static_ops(b.gpu_prog)
    assert r1.static_ops() is r2.static_ops()


def _copy_chain(n_launches, seed):
    """A copy cohort (producer) whose output region feeds a consumer
    cohort's input region: (bench, producer images, consumer images,
    input region, output region, an XOR block)."""
    b = SMALL["copy"]()
    n = b.gpu_n
    prod = [variant_mem(b, seed + k) for k in range(n_launches)]
    cons = [np.zeros_like(b.gpu_mem) for _ in range(n_launches)]
    flips = np.random.default_rng(seed).integers(
        0, 2**31 - 1, (n_launches, n)).astype(np.int32)
    flips[0] = 0                        # a zero row leaves its launch alone
    return b, prod, cons, (0, n), (n, 2 * n), flips


def test_block_patch_chain_equals_reference_and_host_staging():
    """Producer cohort -> consumer cohort through a BlockPatch of the
    producer's device_mem_block, then an XorBlockPatch: the JAX package's
    same chain and the chain staged through the host give the same
    bits."""
    b, prod, cons, (ilo, ihi), (olo, ohi), flips = _copy_chain(3, 7)
    hp = run_kernel_cohort_async(b.gpu_prog, prod, b.gpu_items, CFG,
                                 device=CPU)
    hc = run_kernel_cohort_async(
        b.gpu_prog, cons, b.gpu_items, CFG, device=CPU,
        patches=BlockPatch(ilo, ihi, hp.device_mem_block(olo, ohi)))
    hx = run_kernel_cohort_async(
        b.gpu_prog, cons, b.gpu_items, CFG, device=CPU,
        patches=XorBlockPatch(ilo, ihi, torch.from_numpy(flips)))
    jp = jax_cohort_async(b.gpu_prog, prod, b.gpu_items, JCFG)
    jc = jax_cohort_async(
        b.gpu_prog, cons, b.gpu_items, JCFG,
        patches=JaxBlockPatch(ilo, ihi, jp.device_mem_block(olo, ohi)))
    jx = jax_cohort_async(b.gpu_prog, cons, b.gpu_items, JCFG,
                          patches=JaxXorBlockPatch(ilo, ihi, flips))
    for got, want in ((hc, jc), (hx, jx)):
        for g, w in zip(got.results(), want.results()):
            check_launch(g, w)
    # the same chains through the host
    staged = [c.copy() for c in cons]
    for k, (mem, _) in enumerate(hp.results()):
        staged[k][ilo:ihi] = mem[olo:ohi]
    for g, w in zip(hc.results(), run_kernel_cohort(
            b.gpu_prog, staged, b.gpu_items, CFG, device=CPU)):
        check_launch(g, w)
    flipped = [c.copy() for c in cons]
    for k in range(len(cons)):
        flipped[k][ilo:ihi] ^= flips[k]
    for g, w in zip(hx.results(), run_kernel_cohort(
            b.gpu_prog, flipped, b.gpu_items, CFG, device=CPU)):
        check_launch(g, w)
    # a zero XOR row leaves its launch as it was staged
    check_launch(hx.results()[0], run_kernel(b.gpu_prog, cons[0],
                                             b.gpu_items, CFG, device=CPU))


def test_per_launch_patches_in_list_order_equal_reference():
    """Per-launch patch lists on every path, applied in list order (a
    later patch over the same words wins; "xor" flips), equal the JAX
    package's."""
    b = SMALL["copy"]()
    n = b.gpu_n
    g = np.random.default_rng(3)
    src = [g.integers(-50, 50, n).astype(np.int32) for _ in range(3)]
    first = [(0, n, src[0]), (4, 8, src[1][:4]), (0, 4, src[2][:4], "xor")]
    second = [(0, n, src[1], "set")]
    m = [variant_mem(b, 1), variant_mem(b, 2)]
    cases = [
        (lambda p: run_kernel_async(b.gpu_prog, m[0], b.gpu_items, CFG,
                                    patches=p, device=CPU),
         lambda p: jax_single_async(b.gpu_prog, m[0], b.gpu_items, JCFG,
                                    patches=p),
         first),
        (lambda p: run_kernel_cohort_async(b.gpu_prog, m, b.gpu_items, CFG,
                                           patches=p, device=CPU),
         lambda p: jax_cohort_async(b.gpu_prog, m, b.gpu_items, JCFG,
                                    patches=p),
         [first, second]),
        (lambda p: run_kernel_batch_async(
            [b.gpu_prog, pad_prog(b.gpu_prog, 1)], m, [b.gpu_items] * 2,
            CFG, patches=p, device=CPU),
         lambda p: jax_batch_async(
            [b.gpu_prog, pad_prog(b.gpu_prog, 1)], m, [b.gpu_items] * 2,
            JCFG, patches=p),
         [None, first]),
    ]
    for port_fn, jax_fn, patches in cases:
        for g_, w_ in zip(port_fn(patches).results(),
                          jax_fn(patches).results()):
            check_launch(g_, w_)
    with pytest.raises(ValueError):
        run_kernel_async(b.gpu_prog, m[0], b.gpu_items, CFG, device=CPU,
                         patches=[(0, n, src[0][:3])])
    with pytest.raises(ValueError):
        run_kernel_async(b.gpu_prog, m[0], b.gpu_items, CFG, device=CPU,
                         patches=[(0, 4, src[0][:4], "add")])
    with pytest.raises(ValueError):
        run_kernel_cohort_async(b.gpu_prog, m, b.gpu_items, CFG, device=CPU,
                                patches=BlockPatch(0, 4, torch.zeros(1, 4)))


def test_patches_never_write_the_producer():
    """A torch slice is a view of the producer's final memory: a
    consumer patched from it (set, then xor over the same words) runs,
    and the producer's memory, downloaded before and after, is
    unchanged."""
    b, prod, cons, (ilo, ihi), (olo, ohi), flips = _copy_chain(2, 11)
    hp = run_kernel_cohort_async(b.gpu_prog, prod, b.gpu_items, CFG,
                                 device=CPU)
    before = hp.device_mem_block(0, b.gpu_mem.shape[0]).clone()
    per = [[(ilo, ihi, hp.device_mem(k, (olo, ohi))),
            (ilo, ihi, hp.device_mem(1 - k, (olo, ohi)), "xor")]
           for k in range(2)]
    hc = run_kernel_cohort_async(b.gpu_prog, cons, b.gpu_items, CFG,
                                 patches=per, device=CPU)
    hx = run_kernel_cohort_async(
        b.gpu_prog, cons, b.gpu_items, CFG, device=CPU,
        patches=XorBlockPatch(ilo, ihi, hp.device_mem_block(olo, ohi)))
    hc.results(), hx.results()
    assert torch.equal(hp.device_mem_block(0, b.gpu_mem.shape[0]), before)
    for k, (mem, _) in enumerate(hp.results()):
        np.testing.assert_array_equal(mem, before[k].numpy())
    out0 = hp.results()[0][0][olo:ohi] ^ hp.results()[1][0][olo:ohi]
    np.testing.assert_array_equal(hc.mem(0)[olo:ohi], out0)


def test_mesh_is_not_ported():
    """Only a LaunchMesh shards (the mesh= path itself is held against the
    JAX package in test_torch_mesh.py); anything else is refused."""
    b = SMALL["copy"]()
    with pytest.raises(TypeError, match="LaunchMesh"):
        run_kernel_cohort_async(b.gpu_prog, [b.gpu_mem], b.gpu_items, CFG,
                                mesh=object(), device=CPU)
    with pytest.raises(TypeError, match="LaunchMesh"):
        get_executor(CFG, mesh=object(), device=CPU)
    assert get_executor(CFG, device=CPU).shards == 1
