"""The port's kernel-serving core against the JAX package's, exactly
(the non-Fleet cases of tests/test_serve.py, and the scheduler's
dependency, retry and audit cases of tests/test_graphs.py and
tests/test_resilience.py, on the port with ``device="cpu"``): the
facade, every launch path through ``LaunchQueue`` flushes and incremental
``Scheduler`` drains on all 8 benches, quarantine, priority planning, the
``fifo`` policy, admission, the envelope cache's counters, device-
resident dependency patches, retry and checksum audits."""
import numpy as np
import pytest
from test_torch_parity import (check_launch, pad_prog, small_benches,
                               spinner, variant_mem)

from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro.serve import Dep as JaxDep
from repro.serve import Request as JaxRequest
from repro.serve import Scheduler as JaxScheduler
from repro.serve import plan_chunks as jax_plan_chunks
from repro.serve import plan_fifo as jax_plan_fifo
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import GGPUConfig, KernelLaunchError, run_kernel
from repro_torch.serve import (AdmissionError, ChecksumError, Chunk,
                               DeadlineExceeded, Dep, DependencyError,
                               DeviceTimeout, Executor, LaunchQueue, Request,
                               RetryPolicy, Scheduler, plan_chunks,
                               plan_fifo, plan_waves, result_checksum)

CFG = GGPUConfig(n_cus=2)
JCFG = JaxConfig(n_cus=2)
CPU = "cpu"
SMALL = small_benches()


def test_facade_imports_unchanged():
    from repro_torch.serve.engine import (Engine, EngineConfig,  # noqa: F401
                                          KernelLaunch, LaunchQueue)
    q = LaunchQueue(CFG, device=CPU)
    assert len(q) == 0
    kl = KernelLaunch(np.zeros((1, 5), np.int32), np.zeros(4, np.int32), 1,
                      "t")
    assert kl.tag == "t" and kl.priority == 0


@pytest.mark.parametrize("name", sorted(SMALL))
def test_roundtrip_all_paths_flush_and_drain(name):
    """All three launch paths, a monolithic flush and an incremental drain
    with interleaved submissions, equal the JAX package's launches —
    memory, cycles and stats — on every bench. (A program padded with
    HALT rows behaves as the unpadded one: the reference runs the
    unpadded program once per image.)"""
    b = SMALL[name]()
    progA = b.gpu_prog
    progB = pad_prog(progA, 1)
    progC = pad_prog(progA, 2)
    m0, m1, m2 = b.gpu_mem, variant_mem(b, 1), variant_mem(b, 2)
    launches = [(progB, m1), (progA, m0), (progA, m2), (progC, m0)]
    ref = {k: jax_run_kernel(progA, m, b.gpu_items, JCFG)
           for k, m in ((1, m1), (0, m0), (2, m2))}
    direct = [ref[1], ref[0], ref[2], ref[0]]

    q = LaunchQueue(CFG, device=CPU)
    for p, m in launches:
        q.submit(p, m, b.gpu_items)
    flushed = q.flush()
    assert [r.info["batch_size"] for r in flushed] == [2, 2, 2, 2]
    for res, d in zip(flushed, direct):
        check_launch(res, d)
    q.submit(progA, m0, b.gpu_items)
    (single,) = q.flush()
    assert single.info["batch_size"] == 1
    check_launch(single, direct[1])

    s = Scheduler(CFG, device=CPU)
    s.submit(progB, m1, b.gpu_items)
    s.submit(progA, m0, b.gpu_items)
    first = s.drain(budget=1)
    s.submit(progA, m2, b.gpu_items)
    s.submit(progC, m0, b.gpu_items)
    rest = s.drain()
    assert len(s) == 0 and not s.quarantined
    got = {r.info["ticket"]: r for r in first + rest}
    assert sorted(got) == [0, 1, 2, 3]
    assert [r.info["ticket"] for r in rest] == sorted(
        r.info["ticket"] for r in rest)
    for t, d in enumerate(direct):
        check_launch(got[t], d)


def test_interleaved_drain_matches_monolithic_flush():
    b = SMALL["copy"]()
    mems = [b.gpu_mem] + [variant_mem(b, s) for s in range(1, 5)]
    sub = [(b.gpu_prog, m, b.gpu_items) for m in mems]
    mono = Scheduler(CFG, device=CPU)
    for p, m, n in sub:
        mono.submit(p, m, n)
    expect = {r.info["ticket"]: r for r in mono.flush()}
    inc = Scheduler(CFG, device=CPU)
    inc.submit(*sub[0])
    inc.submit(*sub[1])
    out = inc.drain()
    inc.submit(*sub[2])
    out += inc.drain(budget=1)
    inc.submit(*sub[3])
    inc.submit(*sub[4])
    out += inc.drain()
    assert sorted(r.info["ticket"] for r in out) == sorted(expect)
    for r in out:
        check_launch(r, expect[r.info["ticket"]])
    check_launch(expect[3], jax_run_kernel(*sub[3], JCFG))


def test_scheduler_quarantines_poisoned_launch():
    """A launch that never halts is quarantined; the rest of its chunk and
    the drain complete, equal to the reference's; the scheduler stays
    serviceable and its counters coherent."""
    cfg = GGPUConfig(max_steps=50)
    b = programs._copy(16, 128)
    c2 = programs._copy(8, 64)
    s = Scheduler(cfg, device=CPU)
    t0 = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items, tag="good0")
    t_bad = s.submit(spinner(), np.zeros(8, np.int32), 8, tag="spinner")
    t2 = s.submit(c2.gpu_prog, c2.gpu_mem, c2.gpu_items, tag="good2")
    t3 = s.submit(b.gpu_prog, variant_mem(b, 3), b.gpu_items, tag="good3")
    results = s.drain()
    assert len(s) == 0
    assert [r.info["ticket"] for r in results] == [t0, t2, t3]
    assert set(s.quarantined) == {t_bad}
    assert s.quarantined[t_bad].request.tag == "spinner"
    assert "max_steps" in str(s.quarantined[t_bad].error)
    check_launch(results[1], jax_run_kernel(c2.gpu_prog, c2.gpu_mem,
                                            c2.gpu_items,
                                            JaxConfig(max_steps=50)))
    assert results[1].info["tag"] == "good2"
    s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    assert len(s.drain()) == 1
    st = s.executor.stats
    assert st.trace_hits + st.trace_misses == st.dispatches


def test_scheduler_drain_loses_nothing_on_unexpected_failure():
    b = SMALL["copy"]()
    fir = SMALL["fir"]()
    s = Scheduler(CFG, device=CPU)
    t0 = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    t1 = s.submit(b.gpu_prog, variant_mem(b, 1), b.gpu_items)
    t2 = s.submit(fir.gpu_prog, fir.gpu_mem, fir.gpu_items)
    real_collect = s.executor.collect
    calls = []

    def explode_on_second(pending):
        calls.append(pending.kind)
        if len(calls) == 2:
            raise ValueError("malformed launch")
        return real_collect(pending)

    s.executor.collect = explode_on_second
    with pytest.raises(ValueError):
        s.drain()
    assert s.pending_tickets == [t2]
    s.executor.collect = real_collect
    results = s.drain()
    assert [r.info["ticket"] for r in results] == [t0, t1, t2]
    check_launch(results[0], jax_run_kernel(b.gpu_prog, b.gpu_mem,
                                            b.gpu_items, JCFG))
    check_launch(results[2], jax_run_kernel(fir.gpu_prog, fir.gpu_mem,
                                            fir.gpu_items, JCFG))


def test_scheduler_quarantines_whole_poisoned_cohort():
    s = Scheduler(GGPUConfig(max_steps=50), device=CPU)
    for _ in range(2):
        s.submit(spinner(), np.zeros(8, np.int32), 8)
    assert s.drain() == []
    assert sorted(s.quarantined) == [0, 1]


def test_plan_chunks_priority_and_deadline_order():
    """The planner's chunks and their order equal the reference's, under
    priorities, deadlines and defaults, with either policy."""
    b = SMALL["copy"]()
    fir = SMALL["fir"]()
    rows = [(b.gpu_prog, b.gpu_mem, b.gpu_items, {}),
            (fir.gpu_prog, fir.gpu_mem, fir.gpu_items, {"priority": 1}),
            (b.gpu_prog, variant_mem(b, 1), b.gpu_items, {}),
            (fir.gpu_prog, variant_mem(fir, 2), fir.gpu_items, {}),
            (b.gpu_prog, variant_mem(b, 3), b.gpu_items, {})]

    def plans(meta):
        reqs = [Request(p, m, n, **{**kw, **meta.get(i, {})})
                for i, (p, m, n, kw) in enumerate(rows)]
        jreqs = [JaxRequest(p, m, n, **{**kw, **meta.get(i, {})})
                 for i, (p, m, n, kw) in enumerate(rows)]
        out = []
        for mine, theirs in ((plan_chunks, jax_plan_chunks),
                             (plan_fifo, jax_plan_fifo)):
            for max_batch in (64, 2):
                got = [(c.kind, c.members)
                       for c in mine(reqs, CFG, max_batch)]
                want = [(c.kind, c.members)
                        for c in theirs(jreqs, JCFG, max_batch)]
                assert got == want
                out.append(got)
        return out

    # the priority-1 fir cohort jumps ahead of the earlier-ticket one
    assert [m for _, m in plans({})[0]] == [(1, 3), (0, 2, 4)]
    assert [m for _, m in plans({0: {"deadline_us": 5.0},
                                 2: {"deadline_us": 5.0}})[0]] == \
        [(1, 3), (0, 2, 4)]
    assert [m for _, m in plans({1: {"priority": 0,
                                     "deadline_us": 1.0}})[0]] == \
        [(1, 3), (0, 2, 4)]
    assert [m for _, m in plans({1: {"priority": 0}})[0]] == \
        [(0, 2, 4), (1, 3)]
    fifo = plans({})[2]
    assert [m for _, m in fifo] == [(0,), (1,), (2,), (3,), (4,)]
    assert plans({})[3] == fifo


def test_scheduler_admission_limit():
    b = SMALL["copy"]()
    s = Scheduler(CFG, max_pending=1, device=CPU)
    s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    with pytest.raises(AdmissionError):
        s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    s.drain()
    s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    with pytest.raises(ValueError):
        Scheduler(CFG, max_batch=0, device=CPU)
    with pytest.raises(ValueError):
        Scheduler(CFG, executor=Executor(CFG, device=CPU))
    with pytest.raises(KeyError, match="fifo"):
        Scheduler(CFG, policy="no-such-policy", device=CPU)


def test_plan_waves_slots():
    assert plan_waves(range(5), 2) == [[0, 1], [2, 3], [4]]
    assert plan_waves([], 3) == []
    with pytest.raises(ValueError):
        plan_waves([1], 0)


def test_executor_envelope_cache_hits_on_repeat_traffic():
    """Repeat traffic with the same envelope is a hit; the counters equal
    the JAX scheduler's on the same traffic."""
    b = SMALL["vec_mul"]()
    s = Scheduler(CFG, device=CPU)
    js = JaxScheduler(JCFG)
    for seed in (1, 2):
        s.submit(b.gpu_prog, variant_mem(b, seed), b.gpu_items)
        js.submit(b.gpu_prog, variant_mem(b, seed), b.gpu_items)
    s.drain(), js.drain()
    assert s.executor.stats.dispatches == 1
    assert s.executor.stats.trace_misses == 1
    for seed in (3, 4):
        s.submit(b.gpu_prog, variant_mem(b, seed), b.gpu_items)
        js.submit(b.gpu_prog, variant_mem(b, seed), b.gpu_items)
    for got, want in zip(s.drain(), js.drain()):
        check_launch(got, want)
        assert got.info == want.info
    assert s.executor.stats.trace_hits == 1
    assert s.executor.stats.batch_occupancy == 2.0
    assert 0 < s.executor.stats.hit_rate <= 0.5
    assert s.executor.stats.report() == js.executor.stats.report()


def test_launch_queue_raises_and_restores_on_failure():
    """The legacy strict mode: a poisoned launch fails the whole flush,
    naming its ticket and tag, and every launch is restored; discarding
    it lets the rest flush."""
    cfg = GGPUConfig(max_steps=50)
    b = programs._copy(16, 128)
    q = LaunchQueue(cfg, device=CPU)
    q.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    q.submit(spinner(), np.zeros(8, np.int32), 8, tag="spin")
    with pytest.raises(KernelLaunchError, match="ticket 1.*spin") as exc:
        q.flush()
    assert exc.value.index == 1 and len(q) == 2
    q.discard(1)
    (res,) = q.flush()
    check_launch(res, jax_run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items,
                                     JaxConfig(max_steps=50)))


# -- dependency edges (tests/test_graphs.py's scheduler cases) ---------------

def _host_chain(b, mem0, lo, hi):
    """Producer then consumer staged through the host (the port's sync
    path, itself held against the reference)."""
    prod = run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items, CFG, device=CPU)[0]
    host = mem0.copy()
    host[lo:hi] = prod[lo:hi]
    return run_kernel(b.gpu_prog, host, b.gpu_items, CFG, device=CPU)[0]


def test_manual_dep_chain_equals_reference():
    """A producer -> consumer edge served in one drain: the consumer's
    window is the producer's output on the device, equal to the JAX
    scheduler's same chain and to the chain staged through the host;
    residency is released once the consumer is collected."""
    b = programs._copy(16, 128)
    lo, hi = b.gpu_out.start, b.gpu_out.stop
    consumer_mem = b.gpu_mem.copy()
    consumer_mem[lo:hi] = 0
    out = []
    for sched, dep in ((Scheduler(CFG, device=CPU), Dep),
                       (JaxScheduler(JCFG), JaxDep)):
        t0 = sched.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
        t1 = sched.submit(b.gpu_prog, consumer_mem, b.gpu_items,
                          deps=[dep(t0, (lo, hi), (lo, hi))])
        out.append({r.info["ticket"]: r for r in sched.drain()})
        assert set(out[-1]) == {t0, t1}
        assert sched._resident == {} and sched._dep_waiters == {}
    for t in (0, 1):
        check_launch(out[0][t], out[1][t])
    np.testing.assert_array_equal(out[0][1].mem,
                                  _host_chain(b, consumer_mem, lo, hi))


def test_fused_block_patch_feeds_a_permuted_consumer_chunk():
    """Consumers that each take one producer of one resident cohort, in
    another order, are fed by one fused BlockPatch (rows gathered with
    index_select); results equal the JAX scheduler's."""
    b = programs._copy(16, 128)
    lo, hi = b.gpu_out.start, b.gpu_out.stop
    prods = [variant_mem(b, k) for k in range(3)]
    cons = [variant_mem(b, 10 + k) for k in range(3)]
    order = (2, 0, 1)
    out = []
    for sched, dep in ((Scheduler(CFG, device=CPU), Dep),
                       (JaxScheduler(JCFG), JaxDep)):
        tp = [sched.submit(b.gpu_prog, m, b.gpu_items) for m in prods]
        for k, m in zip(order, cons):
            sched.submit(b.gpu_prog, m, b.gpu_items,
                         deps=[dep(tp[k], (0, hi - lo), (lo, hi))])
        out.append(sched.drain())
    assert len(out[0]) == 6
    for got, want in zip(*out):
        check_launch(got, want)
        assert got.info["ticket"] == want.info["ticket"]
    patched = [m.copy() for m in cons]
    for j, k in enumerate(order):
        patched[j][:hi - lo] = out[0][k].mem[lo:hi]
        check_launch(out[0][3 + j], run_kernel(b.gpu_prog, patched[j],
                                               b.gpu_items, CFG, device=CPU))


def test_dep_src_defaults_and_validation_bounce_at_admission():
    b = programs._copy(16, 128)
    lo, hi = b.gpu_out.start, b.gpu_out.stop
    s = Scheduler(CFG, device=CPU)
    t0 = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items, out_region=(lo, hi))
    t1 = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                  deps=[Dep(t0, (lo, hi))])
    assert s._pending[t1].deps[0].src == (lo, hi)
    with pytest.raises(ValueError):
        s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                 deps=[Dep(999, (0, 4), (0, 4))])
    with pytest.raises(ValueError):
        s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                 deps=[Dep(t0, (0, 4), (0, 8))])
    with pytest.raises(ValueError):
        s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                 deps=[Dep(t0, (0, 4), (10 ** 6, 10 ** 6 + 4))])
    t2 = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items, out_region=(0, 0))
    with pytest.raises(ValueError):
        s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items, deps=[Dep(t2, (0, 4))])
    t3 = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                  deps=[Dep(t0, (0, 4), (0, 4))])
    with pytest.raises(ValueError):
        s.cancel(t0)
    s.cancel(t3)
    assert sorted(r.info["ticket"] for r in s.drain()) == [t0, t1, t2]


def test_residency_survives_across_drains():
    b = programs._copy(16, 128)
    lo, hi = b.gpu_out.start, b.gpu_out.stop
    s = Scheduler(CFG, device=CPU)
    t0 = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    t1 = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                  deps=[Dep(t0, (lo, hi), (lo, hi))])
    first = s.drain(budget=1)
    assert [r.info["ticket"] for r in first] == [t0]
    assert t0 in s._resident
    (res,) = s.drain()
    assert res.info["ticket"] == t1
    np.testing.assert_array_equal(res.mem,
                                  _host_chain(b, b.gpu_mem, lo, hi))
    assert s._resident == {}


def test_dependency_cascade_quarantine():
    cfg = GGPUConfig(max_steps=50)
    b = programs._copy(16, 128)
    s = Scheduler(cfg, device=CPU)
    t_bad = s.submit(spinner(), np.zeros(8, np.int32), 8)
    t_mid = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                     deps=[Dep(t_bad, (0, 4), (0, 4))])
    t_leaf = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                      deps=[Dep(t_mid, (0, 4), (0, 4))])
    t_ok = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    results = s.drain()
    assert [r.info["ticket"] for r in results] == [t_ok]
    assert set(s.quarantined) == {t_bad, t_mid, t_leaf}
    for t in (t_mid, t_leaf):
        assert isinstance(s.quarantined[t].error, DependencyError)
    assert len(s) == 0 and s.inflight_chunks == 0
    assert s._resident == {} and s._dep_waiters == {} and s._poisoned == {}


def test_drain_abandons_cleanly_through_repeated_failures():
    b = programs._copy(16, 128)
    fir = programs._fir(16, 64)
    lo, hi = b.gpu_out.start, b.gpu_out.stop
    s = Scheduler(CFG, device=CPU)
    t0 = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    t1 = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                  deps=[Dep(t0, (lo, hi), (lo, hi))])
    t2 = s.submit(fir.gpu_prog, fir.gpu_mem, fir.gpu_items)
    real_collect = s.executor.collect

    def exploding(pending):
        raise ValueError("malformed launch")

    s.executor.collect = exploding
    for _ in range(2):
        with pytest.raises(ValueError):
            s.drain()
        assert s.inflight_chunks == 0
        assert sorted(s.pending_tickets) == [t0, t1, t2]
    s.executor.collect = real_collect
    results = s.drain()
    assert [r.info["ticket"] for r in results] == [t0, t1, t2]
    assert s.drain() == []
    np.testing.assert_array_equal(results[1].mem,
                                  _host_chain(b, b.gpu_mem, lo, hi))


# -- retry, checksum audits, timeouts, dropped deadlines ---------------------

def _corrupting(executor, times):
    """Wrap ``executor.collect``: the first ``times`` collections flip a
    word of the first result (a silent corruption the audit must see)."""
    real = executor.collect
    left = {"n": times}

    def collect(pending):
        out = real(pending)
        if left["n"] > 0:
            left["n"] -= 1
            out[0].mem[0] ^= 1
        return out

    executor.collect = collect


@pytest.mark.parametrize("retry", (None, RetryPolicy(max_retries=2)))
def test_checksum_audit_retries_or_quarantines(retry):
    """A result that fails its audit is never returned: under a retry
    policy it is re-run and the clean result served (attempts counted);
    without one, or past the budget, it is quarantined with
    ChecksumError."""
    b = SMALL["copy"]()
    clean = run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items, CFG,
                       device=CPU)[0]
    s = Scheduler(CFG, retry=retry, device=CPU)
    _corrupting(s.executor, 1)
    req = Request(b.gpu_prog, b.gpu_mem, b.gpu_items,
                  audit=result_checksum(clean))
    t = s.submit_request(req)
    out = s.drain()
    if retry is None:
        assert out == [] and isinstance(s.quarantined[t].error,
                                        ChecksumError)
    else:
        (res,) = out
        np.testing.assert_array_equal(res.mem, clean)
        assert req.attempts == 1 and not s.quarantined
    s2 = Scheduler(CFG, retry=RetryPolicy(max_retries=1), device=CPU)
    _corrupting(s2.executor, 5)
    t = s2.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    s2._pending[t].audit = result_checksum(clean)
    assert s2.drain() == []
    assert isinstance(s2.quarantined[t].error, ChecksumError)


def test_stuck_chunk_times_out_and_is_retried():
    """A chunk whose collection raises DeviceTimeout (index None: the
    stuck-device failure, blamed on every member) is re-run under a retry
    policy and served; without one, every member is quarantined with it.
    The port's executors collect a retired chunk and never time out, so
    the stuck collection is planted."""
    b = SMALL["copy"]()
    ex = Executor(CFG, device=CPU)
    stuck = {"n": 1}
    real_collect = ex.collect

    def collect(pending):
        if stuck["n"]:
            stuck["n"] -= 1
            raise DeviceTimeout(f"chunk of {len(pending.reqs)} launch(es) "
                                "not resolved")
        return real_collect(pending)

    ex.collect = collect
    s = Scheduler(executor=ex, retry=RetryPolicy(max_retries=1))
    reqs = [Request(b.gpu_prog, variant_mem(b, seed), b.gpu_items)
            for seed in (1, 2)]
    tickets = [s.submit_request(r) for r in reqs]
    out = s.drain()
    assert [r.info["ticket"] for r in out] == tickets == [0, 1]
    assert [r.attempts for r in reqs] == [1, 1]
    check_launch(out[1], jax_run_kernel(b.gpu_prog, variant_mem(b, 2),
                                        b.gpu_items, JCFG))
    stuck["n"] = 1
    s2 = Scheduler(executor=ex)
    s2.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    assert s2.drain() == []
    assert isinstance(s2.quarantined[0].error, DeviceTimeout)
    assert s2.quarantined[0].error.index is None


def test_policy_drop_chunks_quarantine_with_deadline_exceeded():
    """A policy may plan members out as a "drop" chunk: they are
    quarantined with DeadlineExceeded, the rest are served."""
    b = SMALL["copy"]()

    def drop_late(requests, cfg, max_batch=64):
        late = tuple(i for i, r in enumerate(requests)
                     if r.deadline_us < 1.0)
        keep = [i for i in range(len(requests)) if i not in late]
        chunks = [Chunk("drop", late)] if late else []
        return chunks + [Chunk("single", (i,)) for i in keep]

    s = Scheduler(CFG, policy=drop_late, device=CPU)
    t_ok = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    t_late = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items, deadline_us=0.5)
    out = s.drain()
    assert [r.info["ticket"] for r in out] == [t_ok]
    assert isinstance(s.quarantined[t_late].error, DeadlineExceeded)
    assert s.policy == "drop_late"
