"""The port's fleet router, routers and open-loop load generator
(``repro_torch.serve.{fleet, routing, loadgen}``) against the JAX
package's on the CPU: the same numpy-seeded trace goes through both
fleets, and placement, modelled busy time and makespan, the report,
every served memory and stat, quarantines and the pinned makespans must
be equal; the arrival generators draw identical traces."""
import numpy as np
import pytest
from test_torch_parity import STAT_KEYS, spinner, variant_mem

from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.registry import TRAFFIC as JAX_TRAFFIC
from repro.serve import Dep as JaxDep
from repro.serve import Fleet as JaxFleet
from repro.serve import Request as JaxRequest
from repro.serve import bursty_arrivals as jax_bursty
from repro.serve import pinned_makespan as jax_pinned
from repro.serve import poisson_arrivals as jax_poisson
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import GGPUConfig
from repro_torch.registry import TRAFFIC, UnknownPluginError
from repro_torch.serve import (Dep, Fleet, Request, RoundRobinRouter,
                               bursty_arrivals, pinned_makespan,
                               poisson_arrivals, replay)

CPU = "cpu"
# the serve benchmark's fleet leg, cut to one repetition of its trace, on
# its test's two complementary configs (a high-clock 1-CU part, a wide
# 8-CU part)
SMALL, WIDE = dict(n_cus=1, freq_mhz=667.0), dict(n_cus=8, freq_mhz=500.0)


def _fresh_mem(b, rng):
    n = b.gpu_mem.shape[0]
    return np.concatenate([rng.integers(-100, 100, 2 * b.gpu_n)
                           .astype(np.int32),
                           np.zeros(n - 2 * b.gpu_n, np.int32)])


def _trace():
    wide = programs._copy(16, 1024)
    narrow = programs._reduction(64, 256)
    rng = np.random.default_rng(1)
    return [(b.gpu_prog, _fresh_mem(b, rng), b.gpu_items)
            for b in (wide, narrow)], (wide, narrow)


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mem, np.asarray(w.mem))
        for k in STAT_KEYS + ("ticket", "device", "time_us"):
            assert g.info[k] == w.info[k], k


@pytest.mark.parametrize("router", ["earliest-finish", "round-robin"])
def test_fleet_leg_matches_reference(router):
    trace, benches = _trace()
    devs = [("small", SMALL), ("wide", WIDE)]
    ours = Fleet([(n, GGPUConfig(**c)) for n, c in devs], router=router,
                 device=CPU)
    ref = JaxFleet([(n, JaxConfig(**c)) for n, c in devs], router=router)
    for fleet in (ours, ref):
        assert [fleet.submit(*t) for t in trace] == [0, 1]
    got, want = ours.drain(), ref.drain()
    _same_results(got, want)
    assert ours.report() == ref.report()
    assert ours.quarantined == {} == ref.quarantined
    for res, b, (_, mem0, _) in zip(got, benches, trace):
        np.testing.assert_array_equal(res.mem[b.gpu_out],
                                      b.ref(mem0, b.gpu_n))
    if router == "earliest-finish":
        # the wide launch lands on the wide part, the narrow one on the
        # fast small part, and routing beats pinning to either
        assert [r.info["device"] for r in got] == ["wide", "small"]
        for name, c in devs:
            pinned = pinned_makespan(GGPUConfig(**c), trace, device=CPU)
            assert pinned == jax_pinned(JaxConfig(**c), trace)
            assert ours.makespan_us() < pinned
    else:
        assert [r.info["device"] for r in got] == ["small", "wide"]


def test_fleet_surfaces_quarantined_launches():
    """A launch quarantined on its device appears in ``Fleet.quarantined``
    under its fleet ticket, as in the reference; the rest are served."""
    b = programs._copy(16, 128)
    spin = spinner()
    fleets = (Fleet([("only", GGPUConfig(max_steps=50))], device=CPU),
              JaxFleet([("only", JaxConfig(max_steps=50))]))
    for fleet in fleets:
        fleet.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
        fleet.submit(spin, np.zeros(8, np.int32), 8, tag="spin")
    got, want = fleets[0].drain(), fleets[1].drain()
    _same_results(got, want)
    assert set(fleets[0].quarantined) == set(fleets[1].quarantined) == {1}
    assert fleets[0].quarantined[1].request.tag == "spin"
    assert fleets[0].report() == fleets[1].report()


def test_fleet_pins_dependent_requests_to_their_producer():
    """A request with ``deps`` lands on its producer's device whatever the
    router says, its fleet-level producer ticket rewritten to the device's
    local one; the chain equals the reference's. A dep on a ticket the
    fleet never issued is refused."""
    b = programs._copy(16, 128)
    n = b.gpu_n
    devs = [("a", dict(n_cus=1)), ("b", dict(n_cus=2))]
    outs = []
    for fleet, Req, D in (
            (Fleet([(k, GGPUConfig(**c)) for k, c in devs],
                   router="round-robin", device=CPU), Request, Dep),
            (JaxFleet([(k, JaxConfig(**c)) for k, c in devs],
                      router="round-robin"), JaxRequest, JaxDep)):
        fleet.submit(b.gpu_prog, variant_mem(b, 1), b.gpu_items)
        t1 = fleet.submit(b.gpu_prog, variant_mem(b, 2), b.gpu_items)
        fleet.submit_request(Req(b.gpu_prog, variant_mem(b, 3),
                                 b.gpu_items,
                                 deps=(D(t1, (0, n), (n, 2 * n)),)))
        outs.append(fleet.drain())
        assert fleet.placement == {0: "a", 1: "b", 2: "b"}
        with pytest.raises(ValueError):
            fleet.submit_request(Req(b.gpu_prog, b.gpu_mem, b.gpu_items,
                                     deps=(D(10 ** 6, (0, 4), (0, 4)),)))
    _same_results(*outs)


def test_fleet_shard_width_discounts_the_backlog():
    """With one device's ``shards`` stubbed to 4, the router discounts
    its backlog (``_shard_scale``) and a cohort of launches lands there
    mostly, exactly as in the reference; modelled compute is untouched."""
    b = programs._copy(16, 128)
    reports = []
    for fleet in (Fleet([("narrow", GGPUConfig(n_cus=2)),
                         ("wide", GGPUConfig(n_cus=2))], max_batch=4,
                        device=CPU),
                  JaxFleet([("narrow", JaxConfig(n_cus=2)),
                            ("wide", JaxConfig(n_cus=2))], max_batch=4)):
        fleet.devices[1].scheduler.executor.shards = 4
        for seed in range(8):
            fleet.submit(b.gpu_prog, variant_mem(b, seed), b.gpu_items)
        assert len(fleet.drain()) == 8
        reports.append(fleet.report())
    assert reports[0] == reports[1]
    assert reports[0]["placement"]["wide"] > reports[0]["placement"]["narrow"]


def test_fleet_placement_and_defaults():
    with pytest.raises(ValueError, match="unique"):
        Fleet([("dev", GGPUConfig(n_cus=1)), ("dev", GGPUConfig(n_cus=2))],
              device=CPU)
    with pytest.raises(TypeError, match="LaunchMesh"):
        Fleet([GGPUConfig()], mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="at least one"):
        Fleet([], device=CPU)
    fleet = Fleet([GGPUConfig(), GGPUConfig(n_cus=2)], device=CPU)
    assert [d.name for d in fleet.devices] == ["dev0", "dev1"]
    assert all(d.device.type == "cpu" and d.scheduler.executor.device
               == d.device for d in fleet.devices)
    assert isinstance(Fleet([GGPUConfig()], router=RoundRobinRouter(),
                            device=CPU).router, RoundRobinRouter)
    with pytest.raises(UnknownPluginError):
        Fleet([GGPUConfig()], router="no-such-router", device=CPU)


def test_fleet_defaults_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Fleet([GGPUConfig()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pinned_makespan(GGPUConfig(), [])


# -- loadgen -----------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("poisson_arrivals", (200.0, 64, 3)),
    ("poisson_arrivals", (60.0, 24, 5)),
    ("bursty_arrivals", (3, 4, 0.002, 5)),
    ("bursty_arrivals", (8, 16, 0.004, 0)),
    ("poisson", (40, 2)), ("bursty", (30, 7)), ("heavy-tail", (16, 3)),
    ("heavy-tail", (64, 0))])
def test_arrivals_match_reference(name, args):
    """Every generator draws the reference's trace bit for bit (numpy
    draws under one seed), registry adapters included."""
    if name.endswith("_arrivals"):
        got = {"poisson_arrivals": poisson_arrivals,
               "bursty_arrivals": bursty_arrivals}[name](*args)
        want = {"poisson_arrivals": jax_poisson,
                "bursty_arrivals": jax_bursty}[name](*args)
    else:
        got, want = TRAFFIC.get(name)(*args), JAX_TRAFFIC.get(name)(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) >= 0)


def test_arrival_generators_refuse_bad_rates():
    with pytest.raises(ValueError):
        poisson_arrivals(0.0, 4)
    with pytest.raises(ValueError):
        bursty_arrivals(2, 2, 0.0)
    with pytest.raises(ValueError):
        TRAFFIC.get("heavy-tail")(4, 0, median_gap_s=0.0)


def test_replay_serves_a_bursty_trace_through_a_fleet():
    """Open-loop replay against a fleet: every arrival served, latencies
    finite and positive, a spinner quarantined and marked nan without
    stalling the loop."""
    b = programs._copy(16, 128)
    fleet = Fleet([("wide", GGPUConfig(n_cus=4, max_steps=5000)),
                   ("narrow", GGPUConfig(n_cus=2, max_steps=5000))],
                  device=CPU)
    trace = bursty_arrivals(2, 3, 0.001, seed=9)
    spin = spinner()
    res = replay(fleet, trace, lambda i: Request(
        *((spin, np.zeros(8, np.int32), 8) if i == 4
          else (b.gpu_prog, b.gpu_mem, b.gpu_items))))
    assert res.served == trace.size - 1 and res.quarantined == 1
    assert np.isnan(res.latencies[4])
    ok = np.delete(res.latencies, 4)
    assert (ok > 0).all() and res.duration_s > 0
    rep = res.report()
    assert rep["p50_ms"] <= rep["p99_ms"] and rep["rate_per_s"] > 0
    assert rep["served"] == 5 and rep["quarantined"] == 1
