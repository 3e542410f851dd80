"""Registry smoke and cross-product cells: exercise every plugin (PyTorch
port of ``repro.registry.smoke``).

  * :func:`selfcheck` — discovery health: every axis imports its
    providers and is non-empty.
  * :func:`smoke_all` — **one minimal launch per registered scenario**:
    every bench simulates at its smoke sizes and must match its numpy
    reference bit-exactly; every memory system serves a cache-pressure
    kernel functionally unchanged; every chunk-planning policy plans and
    drains a mixed ready set losslessly; every router places a small
    trace with nothing lost; every traffic generator's trace replays
    through a live scheduler; every fault scenario serves a trace on a
    two-device fleet with nothing lost and nothing corrupted. A plugin
    that imports but cannot actually run fails here. (The reference's
    ``smoke_sections`` waits with the ``SECTIONS`` axis.)
  * :func:`run_cell` — one cell of the scenario cross-product: a
    (memsys, policy, router, fault) combination serving every registered
    traffic pattern across a two-device fleet.

Every function takes ``device=`` (``None``: the card; ``"cpu"`` for the
plain path), where every scheduler and fleet it builds runs. Sizes are
deliberately tiny: the point is *coverage of the registered names*.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np

from repro_torch.ggpu.engine import GGPUConfig, run_kernel
from repro_torch.registry import (AXES, BENCHES, FAULTS, MEMSYS, ROUTERS,
                                  SCHEDULERS, TRAFFIC)
from repro_torch.serve import (DeadlineExceeded, Fleet, Request, Scheduler,
                               replay, result_checksum)

Emit = Callable[[str], None]


def _build_smoke(name: str):
    spec = BENCHES.get(name)
    return spec.build(*spec.smoke_sizes) if spec.smoke_sizes \
        else spec.build()


def _check_result(problems: List[str], what: str, bench, res) -> None:
    expect = bench.ref(bench.gpu_mem, bench.gpu_n)
    got = np.asarray(res.mem)[bench.gpu_out]
    if not np.array_equal(got, expect):
        problems.append(f"{what}: result diverges from NumPy reference")


def smoke_benches(emit: Emit, problems: List[str], device=None) -> None:
    """Every registered bench: one launch through a live scheduler."""
    sched = Scheduler(GGPUConfig(n_cus=2), max_batch=8, device=device)
    order: List[str] = []
    for name in BENCHES.names():
        b = _build_smoke(name)
        sched.submit(b.gpu_prog, b.gpu_mem, b.gpu_items, tag=name)
        order.append(name)
    results = sched.drain()
    if len(results) != len(order):
        problems.append(
            f"bench smoke: {len(order)} launches, {len(results)} results "
            f"({sorted(sched.quarantined)} quarantined)")
        return
    for res in results:
        name = res.info["tag"]
        _check_result(problems, f"bench {name!r}", _build_smoke(name), res)
        emit(f"smoke bench {name}: cycles={res.info['cycles']}")


def smoke_memsys(emit: Emit, problems: List[str], device=None) -> None:
    """Every registered memory system: functional results must not
    depend on the cache organization (it only prices the traffic)."""
    b = _build_smoke("xcorr")      # the cache-pressure kernel
    expect = b.ref(b.gpu_mem, b.gpu_n)
    for name in MEMSYS.names():
        mem, info = run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items,
                               GGPUConfig(n_cus=2, memsys=name),
                               device=device)
        if not np.array_equal(np.asarray(mem)[b.gpu_out], expect):
            problems.append(f"memsys {name!r}: functional result diverges")
        if not info["cycles"] > 0:
            problems.append(f"memsys {name!r}: no cycles accounted")
        emit(f"smoke memsys {name}: cycles={info['cycles']}")


def _mixed_requests():
    """A small planner-shaped workload: a same-kernel pair (cohort bait)
    plus two odd shapes, with non-default priorities/deadlines."""
    a = _build_smoke("copy")
    b = _build_smoke("vec_mul")
    return [
        (a, dict(tag="a0", priority=1)),
        (a, dict(tag="a1")),
        (b, dict(tag="b0", deadline_us=10.0)),
        (_build_smoke("div_int"), dict(tag="c0")),
    ]


def smoke_schedulers(emit: Emit, problems: List[str], device=None) -> None:
    """Every registered policy: plan + drain a mixed set losslessly.
    'Lossless' counts preemptive drops: a policy may quarantine a
    request with ``DeadlineExceeded`` (the mixed set's 10us deadline is
    long expired by dispatch time for a wall-clock policy like
    ``deadline-drop``), but nothing may simply vanish."""
    for name in SCHEDULERS.names():
        sched = Scheduler(GGPUConfig(), max_batch=4, policy=name,
                          device=device)
        subs = _mixed_requests()
        by_tag = {kw["tag"]: bench for bench, kw in subs}
        for bench, kw in subs:
            sched.submit(bench.gpu_prog, bench.gpu_mem, bench.gpu_items,
                         **kw)
        results = sched.drain()
        dropped = [t for t, q in sched.quarantined.items()
                   if isinstance(q.error, DeadlineExceeded)]
        if len(results) + len(dropped) != len(subs):
            problems.append(
                f"policy {name!r}: {len(subs)} submitted, "
                f"{len(results)} served, {len(dropped)} dropped")
            continue
        for res in results:
            _check_result(problems, f"policy {name!r}",
                          by_tag[res.info["tag"]], res)
        emit(f"smoke policy {name}: served={len(results)} "
             f"dropped={len(dropped)}")


def smoke_routers(emit: Emit, problems: List[str], device=None) -> None:
    """Every registered router: place a trace on a two-device fleet."""
    for name in ROUTERS.names():
        fleet = Fleet([("small", GGPUConfig(n_cus=1)),
                       ("wide", GGPUConfig(n_cus=4))], router=name,
                      device=device)
        subs = _mixed_requests()
        for bench, kw in subs:
            kw = {k: v for k, v in kw.items() if k == "tag"}
            fleet.submit(bench.gpu_prog, bench.gpu_mem, bench.gpu_items,
                         **kw)
        results = fleet.drain()
        if len(results) != len(subs):
            problems.append(
                f"router {name!r}: {len(subs)} submitted, "
                f"{len(results)} served")
            continue
        for res, (bench, _) in zip(results, subs):
            _check_result(problems, f"router {name!r}", bench, res)
        used = {r.info["device"] for r in results}
        emit(f"smoke router {name}: devices={sorted(used)}")


def smoke_traffic(emit: Emit, problems: List[str], device=None) -> None:
    """Every registered traffic pattern: generate a trace, check its
    shape/determinism, and replay it through a live scheduler."""
    b = _build_smoke("copy")
    for name in TRAFFIC.names():
        gen = TRAFFIC.get(name)
        arr = np.asarray(gen(8, 0), float)
        if arr.shape != (8,):
            problems.append(f"traffic {name!r}: gen(8) -> shape "
                            f"{arr.shape}, want (8,)")
            continue
        if not (np.all(np.isfinite(arr)) and np.all(arr >= 0)
                and np.all(np.diff(arr) >= 0)):
            problems.append(f"traffic {name!r}: arrivals must be finite, "
                            ">= 0, and non-decreasing")
            continue
        if not np.array_equal(arr, np.asarray(gen(8, 0), float)):
            problems.append(f"traffic {name!r}: not deterministic per seed")
            continue
        # compress the trace so the replay finishes in ~tens of ms
        span = float(arr[-1]) or 1.0
        res = replay(Scheduler(GGPUConfig(), max_batch=8, device=device),
                     arr / span * 0.02,
                     lambda i: Request(b.gpu_prog, b.gpu_mem, b.gpu_items))
        if res.served != 8 or res.quarantined:
            problems.append(f"traffic {name!r}: served {res.served}/8, "
                            f"{res.quarantined} quarantined")
        emit(f"smoke traffic {name}: p50={res.p50_ms:.2f}ms")


def smoke_faults(emit: Emit, problems: List[str], device=None) -> None:
    """Every registered fault scenario: build a two-device fleet under
    the scenario's injection + resilience bundle, serve a small trace
    (audited when the scenario asks for audits), and require that
    nothing is lost and that every *served* result is bit-exact with
    the fault-free reference — corruption must be retried or
    quarantined, never silently returned."""
    b = _build_smoke("copy")
    n = 8
    ref_sched = Scheduler(GGPUConfig(n_cus=2), max_batch=n, device=device)
    for _ in range(n):
        ref_sched.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    ref = {r.info["ticket"]: r for r in ref_sched.flush()}
    audits = {t: result_checksum(r.mem) for t, r in ref.items()}
    for name in FAULTS.names():
        sc = FAULTS.get(name)(seed=0)
        fleet = Fleet([("dev0", GGPUConfig(n_cus=1)),
                       ("dev1", GGPUConfig(n_cus=2))],
                      max_batch=n, device=device, **sc.fleet_kwargs())
        for i in range(n):
            fleet.submit_request(Request(
                b.gpu_prog, b.gpu_mem, b.gpu_items,
                audit=audits[i] if sc.audit else None))
        out = fleet.drain()
        if len(out) + len(fleet.quarantined) != n:
            problems.append(
                f"fault {name!r}: {n} submitted, {len(out)} served, "
                f"{len(fleet.quarantined)} quarantined")
            continue
        corrupt = sum(
            1 for r in out
            if not np.array_equal(np.asarray(r.mem),
                                  np.asarray(ref[r.info['ticket']].mem)))
        if corrupt:
            problems.append(f"fault {name!r}: {corrupt} corrupted "
                            "result(s) served silently")
        emit(f"smoke fault {name}: served={len(out)} "
             f"quarantined={len(fleet.quarantined)} "
             f"injections={len(sc.decision_log())}")


def smoke_all(emit: Emit, device=None) -> List[str]:
    """One minimal launch per registered scenario on every axis; returns
    the list of problems (empty = every plugin is launchable)."""
    problems: List[str] = []
    smoke_benches(emit, problems, device)
    smoke_memsys(emit, problems, device)
    smoke_schedulers(emit, problems, device)
    smoke_routers(emit, problems, device)
    smoke_traffic(emit, problems, device)
    smoke_faults(emit, problems, device)
    return problems


def selfcheck(emit: Emit) -> List[str]:
    """Discovery health: every axis imports its providers and is
    non-empty. (Duplicate names and import errors raise during
    discovery; an empty axis is the silent failure this catches — e.g. a
    provider refactor that stopped registering anything.)"""
    problems: List[str] = []
    for axis_name, axis in AXES.items():
        try:
            names = axis.names()
        except Exception as exc:   # noqa: BLE001 — report, don't mask peers
            problems.append(f"axis {axis_name}: discovery failed: "
                            f"{type(exc).__name__}: {exc}")
            continue
        if not names:
            problems.append(f"axis {axis_name}: no plugins registered")
        emit(f"axis {axis_name}: {len(names)} plugins: {', '.join(names)}")
    return problems


def run_cell(memsys: str, policy: str, router: str,
             emit: Emit, fault: str = "none", device=None) -> List[str]:
    """One cross-product cell: replay every registered traffic
    pattern against a two-device fleet built from (memsys, policy,
    router) under the named chaos scenario, failing on lost launches.
    (Per-launch bit-exactness of every scenario is proven by
    ``smoke_all``; cells prove the *combinations* drain cleanly — under
    injection, 'cleanly' means every request is served, rerouted, or
    quarantined with a recorded error, never silently dropped.)"""
    problems: List[str] = []
    benches = [_build_smoke(n) for n in BENCHES.names()]
    for traffic in TRAFFIC.names():
        scenario = FAULTS.get(fault)(seed=0)
        fleet = Fleet(
            [("dev0", GGPUConfig(n_cus=1, memsys=memsys)),
             ("dev1", GGPUConfig(n_cus=4, memsys=memsys))],
            max_batch=8, router=router, policy=policy, device=device,
            **scenario.fleet_kwargs())
        n = 24
        arr = np.asarray(TRAFFIC.get(traffic)(n, 0), float)
        span = float(arr[-1]) or 1.0
        benches_of = [benches[i % len(benches)] for i in range(n)]

        def make(i, _b=benches_of):
            b = _b[i]
            return Request(b.gpu_prog, b.gpu_mem, b.gpu_items,
                           tag=b.name)
        res = replay(fleet, arr / span * 0.05, make)
        lost = n - res.served - res.quarantined
        clean = fault == "none"
        if lost or (clean and (res.served != n or res.quarantined)):
            problems.append(
                f"cell({memsys},{policy},{router},{fault}) x {traffic}: "
                f"served {res.served}/{n}, {res.quarantined} quarantined, "
                f"{lost} lost")
        report = fleet.report()
        emit(f"cell {memsys}/{policy}/{router}/{fault}/{traffic}: "
             f"served={res.served} p99={res.p99_ms:.2f}ms "
             f"placement={report['placement']}")
    return problems
