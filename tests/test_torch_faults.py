"""The port's fault injection and the self-healing fleet
(``repro_torch.faults``, ``Fleet``'s resilient drain, the executor
timeout, the deadline-drop plugin) against the JAX package's on the CPU:
the fault plans draw the same decisions; the ``seu`` and ``device-loss``
scenarios give the same decision log, fleet report and served memory on
the same numpy-seeded traces; and the reference's resilience behaviours
(audit and retry, timeouts, eviction, probation, hedging) hold in the
port."""
import time

import numpy as np
import pytest
from test_torch_parity import STAT_KEYS

from repro.faults import FaultPlan as JaxPlan
from repro.ggpu import programs as jax_programs
from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro.registry import FAULTS as JAX_FAULTS
from repro.serve import Fleet as JaxFleet
from repro.serve import Request as JaxRequest
from repro.serve import result_checksum as jax_checksum
from repro_torch.faults import FaultInjector, FaultPlan
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import GGPUConfig, run_kernel
from repro_torch.registry import FAULTS, SCHEDULERS
from repro_torch.serve import (ChecksumError, DeadlineExceeded, DeviceTimeout,
                               Executor, Fleet, FleetResilience, HedgePolicy,
                               Request, RetryPolicy, Scheduler, plan_chunks,
                               result_checksum)

CPU = "cpu"
CFG = GGPUConfig(n_cus=2)


def _bench():
    return programs._copy(16, 128)


def _mems(b, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(-30, 30, b.gpu_mem.shape[0]).astype(np.int32)
            for _ in range(n)]


def _audited(b, m):
    ref = run_kernel(b.gpu_prog, m, b.gpu_items, CFG, device=CPU)
    return Request(b.gpu_prog, m, b.gpu_items,
                   audit=result_checksum(ref[0])), ref


# -- FaultPlan ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_plan_draws_equal_the_reference(seed):
    """Every decision of a plan — hits, flip coordinates, stragglers,
    stuck devices — equals the reference's over a grid of (ticket,
    attempt): the hashes are copied byte for byte."""
    kw = dict(seed=seed, seu_rate=0.3, seu_post_rate=0.6,
              straggler_rate=0.15, straggler_delay_s=0.25,
              stuck_devices=("dev0",), stuck_after=2)
    ours, ref = FaultPlan(**kw), JaxPlan(**kw)
    assert ours.active == ref.active
    for ticket in range(48):
        for attempt in range(3):
            for fn, extra in (("seu_hit", ()), ("post_hit", ()),
                              ("straggler_hit", ()), ("seu_flip", (97,)),
                              ("post_flip", (5,)), ("seu_flip", (1,))):
                assert getattr(ours, fn)(ticket, attempt, *extra) == \
                    getattr(ref, fn)(ticket, attempt, *extra), \
                    (fn, ticket, attempt)
    for dev in ("dev0", "dev1"):
        for k in range(5):
            assert ours.stuck(dev, k) == ref.stuck(dev, k)


def test_plan_extremes_and_flip_range():
    never = FaultPlan(seed=3)
    always = FaultPlan(seed=3, seu_rate=1.0, seu_post_rate=1.0)
    some = FaultPlan(seed=3, seu_rate=0.4)
    assert not never.active and always.active
    for t in range(32):
        assert not never.seu_hit(t, 0) and not never.post_hit(t, 0)
        assert always.seu_hit(t, 0) and always.post_hit(t, 0)
        if some.seu_hit(t, 0):
            assert always.seu_hit(t, 0)
        word, bit = always.seu_flip(t, 0, msize=17)
        assert 0 <= word < 17 and 0 <= bit < 31


def test_faults_axis_builtins():
    assert FAULTS.names() == JAX_FAULTS.names()
    sc = FAULTS.get("none")(seed=3)
    assert not sc.plan.active and sc.resilience is None and not sc.audit
    sc = FAULTS.get("seu")(seed=3)
    assert sc.plan.active and sc.audit and sc.retry is not None
    sc = FAULTS.get("straggler")(seed=3)
    assert sc.resilience.hedge is not None and sc.timeout_s
    sc = FAULTS.get("device-loss")(seed=3)
    assert sc.plan.stuck_devices == ("dev0",)


# -- the injector ------------------------------------------------------------

def test_inactive_injector_is_a_byte_identical_passthrough():
    b = _bench()
    mems = _mems(b, 4)
    plain = Scheduler(CFG, max_batch=2, device=CPU)
    wrapped = Scheduler(CFG, max_batch=2, device=CPU)
    inner = wrapped.executor
    inj = FaultInjector("d", inner, FaultPlan(seed=5))
    wrapped.executor = inj
    for s in (plain, wrapped):
        for m in mems:
            s.submit(b.gpu_prog, m, b.gpu_items)
    expect, got = plain.flush(), wrapped.flush()
    assert inj.injected == []
    for attr in ("cfg", "stats", "shards", "memo", "timeout_s", "device"):
        assert getattr(inj, attr) is getattr(inner, attr), attr
    assert len(got) == len(expect) == 4
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(g.mem, e.mem)
        assert g.info["cycles"] == e.info["cycles"]


@pytest.mark.parametrize("kind", ["single", "cohort"])
def test_seu_flip_lands_in_staged_memory(kind):
    """A pre-dispatch SEU flips the staged bit (per-launch XOR entry on a
    single, one fused XorBlockPatch on a patch-free cohort): the result
    equals the kernel run over the host image with that bit flipped."""
    b = _bench()
    plan = FaultPlan(seed=4, seu_rate=1.0)
    s = Scheduler(CFG, max_batch=4, device=CPU)
    inj = FaultInjector("d", s.executor, plan)
    s.executor = inj
    mems = _mems(b, 1 if kind == "single" else 3)
    for m in mems:
        s.submit(b.gpu_prog, m, b.gpu_items)
    out = s.flush()
    assert [e[0] for e in inj.injected] == ["seu"] * len(mems)
    for t, (m, res) in enumerate(zip(mems, out)):
        word, bit = plan.seu_flip(t, 0, int(m.shape[0]))
        flipped = m.copy()
        flipped[word] ^= np.int32(1) << bit
        np.testing.assert_array_equal(res.mem, run_kernel(
            b.gpu_prog, flipped, b.gpu_items, CFG, device=CPU)[0])


def test_stuck_device_times_out_through_the_executor_timeout():
    """A wedged device's chunk is never ready; collection raises
    DeviceTimeout once the executor's ``timeout_s`` after dispatch has
    passed, and a scheduler quarantines the launch with it."""
    plan = FaultPlan(seed=0, stuck_devices=("d",), stuck_after=0)
    inj = FaultInjector("d", Executor(CFG, timeout_s=0.05, device=CPU), plan)
    b = _bench()
    pending = inj.submit("single",
                         [Request(b.gpu_prog, b.gpu_mem, b.gpu_items)])
    assert not inj.chunk_ready(pending)
    with pytest.raises(DeviceTimeout):
        inj.collect(pending)
    assert time.monotonic() - pending.t_dispatch >= 0.05
    s = Scheduler(CFG, max_batch=4, device=CPU)
    s.executor.timeout_s = 0.05
    s.executor = FaultInjector("d", s.executor, plan)
    t = s.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    assert s.flush() == []
    assert isinstance(s.quarantined[t].error, DeviceTimeout)


# -- audit and retry ---------------------------------------------------------

def _transient_seed():
    """A seed where ticket 0's first attempt takes post-compute SDC and
    its retry does not."""
    for seed in range(200):
        p = FaultPlan(seed=seed, seu_post_rate=0.5)
        if p.post_hit(0, 0) and not p.post_hit(0, 1):
            return seed
    raise AssertionError("no transient seed in range")


@pytest.mark.parametrize("case", ["transient", "hard", "unaudited"])
def test_checksum_audit_against_silent_corruption(case):
    """Transient SDC is caught by the audit and re-run clean; SDC on every
    attempt is quarantined as a device-blamed ChecksumError, never
    served; without an audit it sails through."""
    b = _bench()
    m = _mems(b, 1)[0]
    req, ref = _audited(b, m)
    if case == "unaudited":
        req.audit = None
    seed = _transient_seed() if case == "transient" else 0
    rate = 0.5 if case == "transient" else 1.0
    s = Scheduler(CFG, retry=RetryPolicy(max_retries=2), device=CPU)
    inj = FaultInjector("d", s.executor,
                        FaultPlan(seed=seed, seu_post_rate=rate))
    s.executor = inj
    s.submit_request(req)
    out = s.flush()
    if case == "transient":
        np.testing.assert_array_equal(out[0].mem, ref[0])
        assert req.attempts == 1 and not s.quarantined
        assert [e[0] for e in inj.injected] == ["sdc"]
    elif case == "hard":
        assert out == [] and req.attempts == 2
        (q,) = s.quarantined.values()
        assert isinstance(q.error, ChecksumError)
        assert type(q.error).device_fault
    else:
        assert not np.array_equal(out[0].mem, ref[0])


# -- scenarios against the reference -----------------------------------------

def _scenario_run(pkg, name, n, seed=0, **kw):
    """One audited trace of ``n`` vec_mul(16, 128) launches on the
    resilience benchmark's two devices under the named scenario; every
    served output checked against the numpy reference."""
    if pkg == "jax":
        prog_mod, Cfg, FleetT, Req, axis, run, cs, extra = (
            jax_programs, JaxConfig, JaxFleet, JaxRequest, JAX_FAULTS,
            jax_run_kernel, jax_checksum, {})
    else:
        prog_mod, Cfg, FleetT, Req, axis, run, cs, extra = (
            programs, GGPUConfig, Fleet, Request, FAULTS,
            lambda *a: run_kernel(*a, device=CPU), result_checksum,
            {"device": CPU})
    b = prog_mod._vec_mul(16, 128)
    rng = np.random.default_rng(13)
    n_words = b.gpu_mem.shape[0]
    mems = [np.concatenate([rng.integers(-100, 100, 2 * b.gpu_n)
                            .astype(np.int32),
                            np.zeros(n_words - 2 * b.gpu_n, np.int32)])
            for _ in range(n)]
    sc = axis.get(name)(seed=seed, **kw)
    fleet = FleetT([("dev0", Cfg(n_cus=1)), ("dev1", Cfg(n_cus=2))],
                   max_batch=8, **sc.fleet_kwargs(), **extra)
    for m in mems:
        audit = cs(run(b.gpu_prog, m, b.gpu_items, Cfg(n_cus=2))[0]) \
            if sc.audit else None
        fleet.submit_request(Req(b.gpu_prog, m, b.gpu_items, audit=audit))
    out = fleet.drain()
    for r in out:
        np.testing.assert_array_equal(
            np.asarray(r.mem)[b.gpu_out],
            b.ref(mems[r.info["ticket"]], b.gpu_n))
    return sc.decision_log(), fleet.report(), out


@pytest.mark.parametrize("name,n,kw", [
    ("seu", 16, {}), ("seu", 12, {"rate": 0.5, "max_retries": 4}),
    ("device-loss", 8, {"stuck_after": 0, "timeout_s": 0.2}),
    ("device-loss", 16, {"stuck_after": 0, "timeout_s": 0.1,
                         "device": "dev1"})])
def test_scenario_matches_reference(name, n, kw):
    """Same seed, same trace: the port's decision log, fleet report (health,
    faults, re-routes, device states, placement, modelled busy time) and
    every served memory and stat equal the JAX package's."""
    log_j, rep_j, out_j = _scenario_run("jax", name, n, **kw)
    log_t, rep_t, out_t = _scenario_run("torch", name, n, **kw)
    assert len(log_t) > 0
    assert log_t == log_j
    assert rep_t == rep_j
    assert len(out_t) == len(out_j) == n
    for g, w in zip(out_t, out_j):
        np.testing.assert_array_equal(g.mem, np.asarray(w.mem))
        for k in STAT_KEYS + ("ticket", "device"):
            assert g.info[k] == w.info[k], k
    if name == "device-loss":
        lost = kw.get("device", "dev0")
        alive = ({"dev0", "dev1"} - {lost}).pop()
        assert rep_t["device_state"] == {lost: "evicted", alive: "active"}
        assert {r.info["device"] for r in out_t} == {alive}
        assert rep_t["reroutes"] > 0 and rep_t["faults"][lost] > 0


def test_same_seed_same_decisions_other_seed_other_decisions():
    a = _scenario_run("torch", "seu", 10, rate=0.6, max_retries=4)
    b = _scenario_run("torch", "seu", 10, rate=0.6, max_retries=4)
    c = _scenario_run("torch", "seu", 10, seed=9, rate=0.6, max_retries=4)
    assert a[0] == b[0] and a[1] == b[1] and a[0] != c[0]
    assert [r.mem.tobytes() for r in a[2]] == [r.mem.tobytes() for r in b[2]]


# -- the self-healing fleet --------------------------------------------------

def _loss_fleet(n=6, timeout_s=0.15, router="earliest-finish"):
    sc = FAULTS.get("device-loss")(seed=0, stuck_after=0,
                                   timeout_s=timeout_s)
    fleet = Fleet([("dev0", GGPUConfig(n_cus=1)), ("dev1", CFG)],
                  max_batch=4, router=router, device=CPU,
                  **sc.fleet_kwargs())
    b = _bench()
    refs = {}
    for m in _mems(b, n):
        req, ref = _audited(b, m)
        refs[fleet.submit_request(req)] = ref
    return fleet, refs, sc


def test_probation_readmission_and_promotion():
    """An evicted device is re-admitted on probation after the cooldown;
    still faulty, its first new fault re-evicts it; healed, a clean
    probation drain promotes it back to active. Nothing is lost."""
    fleet, refs, sc = _loss_fleet(router="round-robin")
    results = fleet.drain()
    dev0 = fleet.devices[0]
    assert dev0.state == "evicted" and not fleet.quarantined
    for res in results:
        np.testing.assert_array_equal(res.mem, refs[res.info["ticket"]][0])
    b = _bench()

    def serve_pair(seed):
        for i in range(2):
            req, _ = _audited(b, _mems(b, 1, seed=seed + 100 * i)[0])
            fleet.submit_request(req)
        fleet.drain()

    cooldown = fleet.resilience.probation_after
    for i in range(cooldown):
        serve_pair(seed=10 + i)
        assert dev0.state == "evicted"
    fleet.drain()
    assert dev0.state == "probation" and dev0.probation_left > 0
    serve_pair(seed=20)
    assert dev0.state == "evicted" and dev0.faults >= 3
    assert not fleet.quarantined
    for inj in sc.injectors:
        inj.plan = FaultPlan(seed=0)
    for i in range(cooldown):
        serve_pair(seed=30 + i)
    fleet.drain()
    assert dev0.state == "probation"
    serve_pair(seed=40)
    assert dev0.state == "active"
    assert dev0.consecutive_faults == 0 and dev0.served > 0
    assert fleet.report()["health"]["dev0"] < 1.0


def _straggling_fleet(delay_s, after_s, b, mems):
    plan = FaultPlan(seed=0, straggler_rate=1.0, straggler_delay_s=delay_s)

    def wrap(name, ex):
        return FaultInjector(name, ex, plan) if name == "dev0" else ex

    fleet = Fleet([("dev0", CFG), ("dev1", CFG)], max_batch=1,
                  resilience=FleetResilience(hedge=HedgePolicy(
                      after_s=after_s)),
                  timeout_s=5.0, executor_wrap=wrap, device=CPU)
    return fleet, [fleet.submit(b.gpu_prog, m, b.gpu_items) for m in mems]


def test_hedge_wins_and_the_loser_is_discarded():
    """A straggling chunk is hedged onto the idle clean device; the hedge
    wins the fleet ticket, the drain returns before the hold expires (the
    loser abandoned in flight), and a later drain discards the loser."""
    b = _bench()
    m = _mems(b, 1)[0]
    ref = run_kernel(b.gpu_prog, m, b.gpu_items, CFG, device=CPU)
    fleet, (t,) = _straggling_fleet(0.6, 0.03, b, [m])
    t0 = time.monotonic()
    (res,) = fleet.drain()
    assert time.monotonic() - t0 < 0.5
    assert res.info["ticket"] == t and res.info["device"] == "dev1"
    np.testing.assert_array_equal(res.mem, ref[0])
    assert res.info["settled_s"] <= time.monotonic()
    assert fleet.report()["hedged"] == 1
    assert fleet.devices[0].scheduler.inflight_chunks == 1
    time.sleep(0.7)
    assert fleet.drain() == []
    assert fleet.devices[0].scheduler.inflight_chunks == 0
    assert not fleet.quarantined


def test_hedge_fires_at_most_once_per_ticket():
    b = _bench()
    fleet, tickets = _straggling_fleet(0.3, 0.02, b, _mems(b, 3))
    results = fleet.drain()
    assert sorted(r.info["ticket"] for r in results) == tickets
    assert 1 <= fleet.report()["hedged"] <= len(tickets)
    # a hedged ticket maps from two (device, local ticket) pairs, any
    # other from one
    copies = {t: list(fleet._tickets.values()).count(t) for t in tickets}
    assert sorted(copies.values()) == [1] * (len(tickets) - len(
        fleet._hedged)) + [2] * len(fleet._hedged)


# -- the deadline-drop plugin ------------------------------------------------

def test_deadline_drop_plans_expired_requests_out():
    plan = SCHEDULERS.get("deadline-drop")
    b = _bench()
    fresh = Request(b.gpu_prog, b.gpu_mem, b.gpu_items)
    fresh.arrival_s = time.monotonic()
    expired = Request(b.gpu_prog, _mems(b, 1)[0], b.gpu_items,
                      deadline_us=1.0)
    expired.arrival_s = time.monotonic() - 1.0
    chunks = plan([fresh, expired], CFG, 4)
    assert chunks[0].kind == "drop" and chunks[0].members == (1,)
    assert [c.members for c in chunks[1:]] == [(0,)]
    reqs = [Request(b.gpu_prog, m, b.gpu_items) for m in _mems(b, 3)]
    assert [(c.kind, c.members) for c in plan(reqs, CFG, 4)] \
        == [(c.kind, c.members) for c in plan_chunks(reqs, CFG, 4)]


@pytest.mark.parametrize("where", ["scheduler", "fleet"])
def test_deadline_drop_quarantines_expired(where):
    b = _bench()
    target = Scheduler(CFG, policy="deadline-drop", device=CPU) \
        if where == "scheduler" else \
        Fleet([("dev0", CFG)], policy="deadline-drop", device=CPU)
    t_late = target.submit(b.gpu_prog, _mems(b, 1)[0], b.gpu_items,
                           deadline_us=50.0)
    t_ok = target.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    time.sleep(0.01)                        # 10 ms >> the 50 us budget
    out = target.drain()
    assert [r.info["ticket"] for r in out] == [t_ok]
    assert isinstance(target.quarantined[t_late].error, DeadlineExceeded)
