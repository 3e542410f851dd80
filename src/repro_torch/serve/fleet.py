"""Fleet router: serve one launch stream across *multiple* G-GPU configs
(PyTorch port of ``repro.serve.fleet``).

This is the layer that connects the DSE output to the serving path: the
Pareto front ``repro_torch.dse.search`` emits is a set of complementary
designs (e.g. a small high-clock 1-CU part and a wide derated 8-CU part),
and a mixed traffic trace is served fastest by placing each launch on the
device that finishes it earliest — small single-wavefront launches on the
fast small part, wide launches on the wide one.

Placement is greedy earliest-finish-time: for each request the router
estimates its service time on every device — from the learned per-kernel
cycle model once the device has served that kernel, from an analytic
occupancy proxy (wavefront rounds / CU parallelism, scaled by clock) on a
cold start — and picks the device minimizing (modeled queue backlog +
estimated service time), with the backlog discounted by the device's
shard width (``_shard_scale``: its executor's mesh extent). Modeled
wall-clock of a fleet is the makespan: the max over devices of the sum
of served launch times (devices run in parallel); ``pinned_makespan``
prices the whole trace on one config for comparison.

**Kernel graphs.** A request carrying ``deps`` is not routed freely: its
producers' device-resident outputs feed it with no host hop, so it must
land on the device already holding every producer. The router looks the
producers up in its placement map, requires them to agree on one device,
and translates the fleet-level producer tickets into that device
scheduler's local tickets before handing the request down. The learned
service-time model keys on *(kernel, schedule)* — ``Request.schedule``
carries the lowering-schedule label — because a tuned and a default
lowering of one kernel are different programs with different true cycle
counts.

**One card, many simulated devices.** ``Fleet(device=)`` puts every
simulated device's executor on that torch device (the card by default;
``"cpu"`` for the plain path). The plain ``drain`` dispatches every
device before collecting any, as the reference does, but a port dispatch
returns only after its chunk has retired, so the simulated devices take
turns on the card: modeled ``busy_us`` and ``makespan_us`` are the
reference's, and wall-clock fleet numbers are the card's own.

**Placement on a mesh.** ``Fleet(mesh=)`` (a
``repro_torch.launch.mesh.LaunchMesh``) binds simulated devices to the
mesh's entries: ``_mesh_slices`` cuts the entries into one contiguous
slice per simulated device, largest first. A slice of several entries
becomes that device's sub-mesh (its executor shards each chunk over
them, ``FleetDevice.mesh``), a slice of one entry its executor's
``device``; an empty slice (more simulated devices than entries) leaves
the device unplaced, on the fleet's ``device``. The router's backlog then
reads each device's real shard width.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import _device
from repro_torch.ggpu.engine import (GGPUConfig, KernelLaunchError,
                                     launch_shards)
from repro_torch.launch.mesh import LaunchMesh
from repro_torch.registry import ROUTERS
from repro_torch.serve.executors import Executor
from repro_torch.serve.request import Request, Result
from repro_torch.serve.scheduler import (Quarantined, RetryPolicy, Scheduler,
                                         wavefronts)


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """Deadline-aware hedged dispatch: once a dispatched chunk has been
    in flight longer than ``after_s`` wall-clock seconds, each of its
    dependency-free members is *duplicated* onto the healthiest idle
    routable device. First result wins the fleet ticket; the loser's
    result (or its eventual quarantine) is discarded at collect. At most
    one hedge per fleet ticket."""
    after_s: float = 0.05


@dataclasses.dataclass(frozen=True)
class FleetResilience:
    """Self-healing fleet policy. ``evict_after`` consecutive device faults
    (``DeviceTimeout``/``ChecksumError`` quarantines, i.e. failures blamed
    on the *device*, not the program) evict a device: its dependency-free
    backlog is re-routed to the survivors, everything else is quarantined,
    and the fleet effectively shrinks. After ``probation_after`` further
    drains the device is re-admitted **on probation** — routable for at
    most ``probation_budget`` requests — and promoted back to active after
    a clean drain, or re-evicted on its first new fault. ``hedge``
    optionally enables straggler hedging (:class:`HedgePolicy`)."""
    evict_after: int = 3
    probation_after: int = 2
    probation_budget: int = 4
    hedge: Optional[HedgePolicy] = None


@dataclasses.dataclass
class FleetDevice:
    """One config in the fleet, with its scheduler and load accounting.
    ``device`` is the torch device its executor runs unsharded launches
    on, ``mesh`` its sub-mesh when it is bound to several mesh entries
    (``None`` otherwise). The health fields move only under a
    :class:`FleetResilience` policy: ``state`` walks active -> evicted ->
    probation -> active, ``faults`` counts device-blamed quarantines,
    ``served`` successful results."""
    name: str
    cfg: GGPUConfig
    scheduler: Scheduler
    eta_us: float = 0.0        # modeled backlog the router sees (estimates)
    busy_us: float = 0.0       # actual modeled service time after drain
    device: object = None      # torch device of its executor
    mesh: object = None        # sub-mesh when bound to >1 mesh entries
    state: str = "active"      # active | evicted | probation
    served: int = 0            # successful results (health numerator)
    faults: int = 0            # device-blamed quarantines (lifetime)
    consecutive_faults: int = 0  # reset by any successful result
    evicted_at: int = -1       # fleet drain counter at eviction
    probation_left: int = 0    # admission budget while on probation

    @property
    def health(self) -> float:
        """Smoothed success fraction in (0, 1]: ``(1 + served) /
        (1 + served + 4 * faults)`` — the +1 prior keeps a cold device
        routable, the 4x fault weight makes one fault cost four serves
        to win back (hedging and re-routing prefer high-health
        devices)."""
        return (1.0 + self.served) / (1.0 + self.served + 4.0 * self.faults)


def _mesh_slices(mesh, n: int) -> List[list]:
    """Partition a launch mesh's entries into ``n`` contiguous slices,
    proportionally (largest first). Empty slices mean the fleet outnumbers
    the mesh's entries; those simulated devices stay unplaced."""
    devices = list(mesh.devices)
    out, lo = [], 0
    for i in range(n):
        take = -((len(devices) - lo) // -(n - i))   # ceil of remaining/n
        out.append(devices[lo:lo + take])
        lo += take
    return out


class Fleet:
    """Routes submissions across devices; drains every device's scheduler.

    ``configs`` may be raw ``GGPUConfig``s or (name, config) pairs —
    e.g. ``[(p.label(), p.point.config) for p in result.frontier]``.
    ``device`` is the torch device every simulated device runs on
    (``None``: the card); ``mesh`` binds simulated devices to the mesh's
    entries instead, ``device`` then holding only the unplaced ones
    (module doc). ``router`` picks the placement strategy by registered
    name (the ``ROUTERS`` registry axis; ``"earliest-finish"`` is the
    legacy greedy placement, see ``repro_torch.serve.routing``) or as a
    router instance/class with a ``pick(fleet, req)`` method. ``policy``
    is forwarded to every device scheduler (``SCHEDULERS`` axis).
    """

    def __init__(self, configs: Sequence, max_batch: int = 64, *,
                 mesh=None, device=None, router="earliest-finish",
                 policy="cohort",
                 resilience: Optional[FleetResilience] = None,
                 retry: Optional[RetryPolicy] = None,
                 timeout_s: Optional[float] = None,
                 executor_wrap: Optional[Callable] = None):
        configs = list(configs)
        launch_shards(mesh)                   # only a LaunchMesh places
        slices = _mesh_slices(mesh, len(configs)) if mesh is not None \
            else [[] for _ in configs]
        self.devices: List[FleetDevice] = []
        for i, c in enumerate(configs):
            name, cfg = c if isinstance(c, tuple) else (f"dev{i}", c)
            sub_mesh = LaunchMesh(slices[i]) if len(slices[i]) > 1 else None
            dev = slices[i][0] if slices[i] else _device.resolve(device)
            # the scheduler's private executor is built here (identical
            # to what Scheduler(cfg, ...) would build) so a caller's
            # ``executor_wrap(name, executor)`` hook — e.g. a
            # ``repro_torch.faults.FaultInjector`` — can interpose per
            # device
            ex = Executor(cfg, mesh=sub_mesh, device=dev,
                          timeout_s=timeout_s)
            if executor_wrap is not None:
                ex = executor_wrap(name, ex) or ex
            self.devices.append(FleetDevice(
                name, cfg,
                Scheduler(executor=ex, max_batch=max_batch, policy=policy,
                          retry=retry),
                device=dev, mesh=sub_mesh))
        if len(self.devices) < 1:
            raise ValueError("fleet needs at least one device")
        self.resilience = resilience
        self._drains = 0                 # drain calls (probation clock)
        self._served_tickets: set = set()   # fleet tickets with a result
        self._hedged: set = set()           # fleet tickets hedged once
        self._reroutes: Dict[int, int] = {}  # fleet ticket -> re-routes
        # routing strategy: a registered name resolves to a router class
        # on the ROUTERS axis; classes are instantiated per fleet
        # (routers may carry state), prebuilt instances pass through
        if isinstance(router, str):
            router = ROUTERS.get(router)
        self.router = router() if isinstance(router, type) else router
        names = [d.name for d in self.devices]
        if len(set(names)) != len(names):
            raise ValueError(f"fleet device names must be unique: {names}"
                             " (names key the routing and result maps)")
        # learned service times: (device name, kernel key, schedule
        # label) -> time_us — the schedule is part of the identity
        # (module doc: a tuned lowering is a different program)
        self._learned: Dict[Tuple[str, tuple, str], float] = {}
        self.placement: Dict[int, str] = {}     # fleet ticket -> device name
        self._next_ticket = 0
        self._tickets: Dict[Tuple[str, int], int] = {}  # (dev, local) -> fleet
        self._local: Dict[int, int] = {}                # fleet -> local
        self._kernel_keys: Dict[int, tuple] = {}  # fleet -> (kernel, sched)
        self._eta_charged: Dict[int, float] = {}        # fleet -> estimate
        self.quarantined: Dict[int, Quarantined] = {}   # by fleet ticket

    # -- service-time model --------------------------------------------------

    def estimate_us(self, dev: FleetDevice, req: Request) -> float:
        """Expected service time of ``req`` on ``dev``: the learned value
        when this device has served this kernel, else an occupancy proxy —
        each of the kernel's ``W`` wavefronts issues its program once over
        ``n_cus``-way CU parallelism at the device's clock."""
        learned = self._learned.get(
            (dev.name, req.kernel_key(), req.schedule))
        if learned is not None:
            return learned
        W = wavefronts(req.n_items, dev.cfg)
        rounds = math.ceil(W / dev.cfg.n_cus) * req.prog.shape[0]
        return rounds * dev.cfg.issue_cycles / dev.cfg.freq_mhz

    @staticmethod
    def _shard_scale(dev: FleetDevice) -> float:
        """Backlog scale for a device's physical shard width: a device
        that dispatches same-shape launches ``shards`` abreast drains a
        stream of launches ~``shards``x faster in wall-clock even though
        each launch's modeled cycles are unchanged. ``shards`` is the
        extent of the device's sub-mesh (1 unsharded);
        ``busy_us``/``makespan_us`` (modeled *compute*) never see it."""
        return 1.0 / max(1, dev.scheduler.executor.shards)

    def finish_us(self, dev: FleetDevice, req: Request) -> float:
        """Modeled finish time of placing ``req`` on ``dev`` now: the
        shard-width-discounted backlog plus this launch's charge."""
        return dev.eta_us + self.estimate_us(dev, req) \
            * self._shard_scale(dev)

    # -- routing -------------------------------------------------------------

    def routable_devices(self) -> List[FleetDevice]:
        """The devices a router may place fresh work on: all of them
        without a resilience policy; otherwise the active ones plus
        probation devices with admission budget left. Falls back to
        not-evicted (then to everything) rather than going empty — a
        fully-degraded fleet still routes somewhere instead of
        crashing."""
        if self.resilience is None:
            return list(self.devices)
        out = [d for d in self.devices
               if d.state == "active"
               or (d.state == "probation" and d.probation_left > 0)]
        return out or [d for d in self.devices if d.state != "evicted"] \
            or list(self.devices)

    def submit(self, prog: np.ndarray, mem0: np.ndarray, n_items: int,
               tag: str = "", priority: int = 0,
               deadline_us: float = math.inf) -> int:
        """Route a launch to the device with the earliest modeled finish
        time; returns a fleet-level ticket."""
        return self.submit_request(
            Request(prog, mem0, n_items, tag, priority, deadline_us))

    def _dep_device(self, req: Request) -> FleetDevice:
        """The one device holding every producer of ``req`` (module doc:
        graph stages co-locate to preserve device residency)."""
        names = set()
        for d in req.deps:
            name = self.placement.get(d.producer)
            if name is None:
                raise ValueError(
                    f"dep producer ticket {d.producer} is unknown to "
                    f"this fleet")
            names.add(name)
        if len(names) > 1:
            raise ValueError(
                f"graph stages must co-locate on one device to stay "
                f"device-resident; producers span {sorted(names)}")
        (name,) = names
        return next(d for d in self.devices if d.name == name)

    def submit_request(self, req: Request) -> int:
        """Route a prebuilt ``Request`` (the ``loadgen.replay`` target
        protocol, shared with ``Scheduler.submit_request``). A request
        with ``deps`` is pinned to its producers' device, with the
        fleet-level producer tickets rewritten to that scheduler's local
        tickets on the way down."""
        if req.deps:
            dev = self._dep_device(req)
            req.deps = tuple(
                dataclasses.replace(d, producer=self._local[d.producer])
                for d in req.deps)
        else:
            dev = self.router.pick(self, req)
        if dev.state == "probation":
            dev.probation_left -= 1
        est = self.estimate_us(dev, req) * self._shard_scale(dev)
        local = dev.scheduler.submit_request(req)
        dev.eta_us += est
        ticket = self._next_ticket
        self._next_ticket += 1
        self.placement[ticket] = dev.name
        self._tickets[(dev.name, local)] = ticket
        self._local[ticket] = local
        self._kernel_keys[ticket] = (req.kernel_key(), req.schedule)
        self._eta_charged[ticket] = est
        return ticket

    def drain(self, budget: Optional[int] = None) -> List[Result]:
        """Drain every device (``budget`` applies per device); returns the
        completed results in fleet-ticket order, each stamped with
        ``info['device']`` and the fleet ``info['ticket']``. Every
        device's chunks are **dispatched before any device is collected**,
        as in the reference (in the port each dispatch has retired when it
        returns: module doc). Actual
        service times update the device loads (replacing the estimate the
        router charged at submit time, so cold-start error never skews
        later placements) and the learned per-kernel model. Launches the
        device scheduler quarantined surface in ``Fleet.quarantined``
        under their fleet ticket — they produce no result.

        Under a :class:`FleetResilience` policy the drain switches to the
        readiness-ordered self-healing loop (``_drain_resilient``);
        without one this is the original dispatch-all-then-collect path,
        unchanged."""
        if self.resilience is not None:
            return self._drain_resilient(budget)
        for dev in self.devices:
            dev.scheduler.dispatch(budget)
        out: List[Result] = []
        for dev in self.devices:
            for res in dev.scheduler.collect():
                local = res.info["ticket"]
                t_us = res.info["cycles"] / dev.cfg.freq_mhz
                dev.busy_us += t_us
                res.info["device"] = dev.name
                ticket = self._tickets[(dev.name, local)]
                res.info["ticket"] = ticket
                kk, sched = self._kernel_keys[ticket]
                self._learned[(dev.name, kk, sched)] = t_us
                # reconcile the modeled backlog with the actual time
                # (shard-discounted the same way the submit charge was)
                scaled = t_us * self._shard_scale(dev)
                dev.eta_us += scaled - self._eta_charged.pop(ticket, scaled)
                out.append(res)
            for local, q in dev.scheduler.quarantined.items():
                ticket = self._tickets[(dev.name, local)]
                if ticket not in self.quarantined:
                    self.quarantined[ticket] = q
                    dev.eta_us -= self._eta_charged.pop(ticket, 0.0)
        out.sort(key=lambda r: r.info["ticket"])
        return out

    # -- self-healing drain (FleetResilience) --------------------------------

    def _drain_resilient(self, budget: Optional[int] = None) -> List[Result]:
        """The readiness-ordered drain loop: dispatch every live device,
        then settle whichever chunks are resolvable *anywhere* — a
        straggling device never serializes the others' collections. Each
        pass harvests device-blamed quarantines into the health counters,
        re-routes dependency-free failures to the healthiest survivor,
        evicts devices past ``evict_after`` consecutive faults (re-routing
        their backlog), and fires straggler hedges. ``budget`` applies per
        device per dispatch pass. The loop exits when every fleet ticket
        is settled or quarantined — NOT when every chunk has resolved: a
        hedge loser still in flight is *abandoned* here and discarded by
        a later drain's collect, so a straggling duplicate never holds
        the drain (and the caller's admission loop) hostage. Probation
        bookkeeping brackets the loop: eviction cooldowns expire on
        entry, clean probation devices are promoted on exit."""
        r = self.resilience
        self._drains += 1
        for dev in self.devices:
            if dev.state == "evicted" \
                    and self._drains - dev.evicted_at > r.probation_after:
                dev.state = "probation"
                dev.probation_left = r.probation_budget
                dev.consecutive_faults = 0
        start_served = {d.name: d.served for d in self.devices}
        out: List[Result] = []
        while True:
            live = [d for d in self.devices if d.state != "evicted"]
            for dev in live:
                dev.scheduler.dispatch(budget)
            progress = False
            for dev in live:
                if dev.state == "evicted":
                    continue  # evicted by an earlier harvest this pass
                got = dev.scheduler.collect_ready()
                if got:
                    progress = True
                self._settle(dev, got, out)
                self._harvest(dev, out)
            if not self._unsettled():
                break  # abandoned hedge losers may remain in flight
            if self._maybe_hedge():
                progress = True
            if not progress:
                live = [d for d in self.devices if d.state != "evicted"]
                if not any(d.scheduler.inflight_chunks
                           or len(d.scheduler) for d in live):
                    break  # unresolved tickets with nowhere left to run
                # nothing resolvable anywhere: poll rather than block on
                # one device, so a hedge winner elsewhere is settled the
                # moment it finishes (blocking on the oldest chunk would
                # hand the straggler the race by default)
                time.sleep(1e-3)
        for dev in self.devices:
            if dev.state == "probation" and dev.consecutive_faults == 0 \
                    and dev.served > start_served[dev.name]:
                dev.state = "active"
        out.sort(key=lambda r: r.info["ticket"])
        return out

    def _unsettled(self) -> bool:
        """Any fleet ticket not yet settled or finally quarantined? (The
        resilient drain's exit condition — a hedge loser's in-flight
        chunk does not count, so it cannot block the drain.)"""
        return any(t not in self._served_tickets
                   and t not in self.quarantined for t in self.placement)

    def _settle(self, dev: FleetDevice, results: List[Result],
                out: List[Result]) -> None:
        """Account device-local results into the fleet surface (the
        resilient-path twin of the default drain's collect loop). The
        first result for a fleet ticket wins; a hedge loser's result is
        discarded here — 'cancelled at collect'. Each winner is stamped
        with ``info['settled_s']`` (monotonic settle time) so an
        open-loop driver can measure when the result actually landed
        rather than when the whole drain returned."""
        for res in results:
            local = res.info["ticket"]
            ticket = self._tickets[(dev.name, local)]
            if ticket in self._served_tickets:
                continue  # hedge loser: the duplicate already won
            self._served_tickets.add(ticket)
            res.info["settled_s"] = time.monotonic()
            t_us = res.info["cycles"] / dev.cfg.freq_mhz
            dev.busy_us += t_us
            res.info["device"] = dev.name
            res.info["ticket"] = ticket
            kk, sched_label = self._kernel_keys[ticket]
            self._learned[(dev.name, kk, sched_label)] = t_us
            scaled = t_us * self._shard_scale(dev)
            dev.eta_us += scaled - self._eta_charged.pop(ticket, scaled)
            dev.served += 1
            dev.consecutive_faults = 0
            out.append(res)

    def _harvest(self, dev: FleetDevice, out: List[Result]) -> None:
        """Drain a device scheduler's quarantine surface into the fleet:
        device-blamed errors (``device_fault``) move the health counters
        and — for dependency-free requests with re-route budget left —
        send the request to the healthiest other device instead of a
        final quarantine. Ends with the eviction check: ``evict_after``
        consecutive faults (a single fault on probation) retire the
        device."""
        sched = dev.scheduler
        for local in list(sched.quarantined):
            q = sched.quarantined.pop(local)
            ticket = self._tickets[(dev.name, local)]
            fault = getattr(type(q.error), "device_fault", False)
            if fault:
                dev.faults += 1
                dev.consecutive_faults += 1
            dev.eta_us -= self._eta_charged.pop(ticket, 0.0)
            if ticket in self._served_tickets or ticket in self.quarantined:
                continue  # a hedge (or an earlier pass) already settled it
            target = None
            if fault and not q.request.deps and self._reroutes.get(
                    ticket, 0) < max(1, len(self.devices) - 1):
                target = self._healthiest(exclude=dev)
            if target is not None:
                self._resubmit(ticket, q.request, target)
            else:
                self.quarantined[ticket] = q
        if dev.state != "evicted" and dev.consecutive_faults >= \
                (1 if dev.state == "probation" else
                 self.resilience.evict_after):
            self._evict(dev, out)

    def _resubmit(self, ticket: int, req: Request,
                  target: FleetDevice) -> None:
        """Re-route a request to ``target`` under its existing fleet
        ticket (fresh local ticket, fresh retry budget; the admission
        stamp survives, so a deadline keeps counting)."""
        self._reroutes[ticket] = self._reroutes.get(ticket, 0) + 1
        req.ticket = -1
        req.attempts = 0
        local = target.scheduler.submit_request(req)
        if target.state == "probation":
            target.probation_left -= 1
        est = self.estimate_us(target, req) * self._shard_scale(target)
        target.eta_us += est
        self.placement[ticket] = target.name
        self._tickets[(target.name, local)] = ticket
        self._local[ticket] = local
        self._eta_charged[ticket] = est

    def _evict(self, dev: FleetDevice, out: List[Result]) -> None:
        """Retire a device: flush its in-flight chunks (without retrying
        on the dying device — stuck chunks resolve via ``DeviceTimeout``
        straight to quarantine), quarantine the backlog that cannot move
        (graph requests are pinned by device residency), and re-route the
        dependency-free rest to the survivors."""
        dev.state = "evicted"
        dev.evicted_at = self._drains
        sched = dev.scheduler
        saved, sched.retry = sched.retry, None
        try:
            self._settle(dev, sched.collect(), out)
        finally:
            sched.retry = saved
        for t in list(sched.pending_tickets):
            req = sched._pending.get(t)
            if req is not None and (req.deps or sched._dep_waiters.get(t)):
                # cascades to its pending consumers via dep poisoning
                sched._quarantine(req, KernelLaunchError(
                    f"device {dev.name} evicted"))
        for t in list(sched.pending_tickets):
            req = sched.cancel(t)
            ticket = self._tickets[(dev.name, t)]
            dev.eta_us -= self._eta_charged.pop(ticket, 0.0)
            target = self._healthiest(exclude=dev)
            if target is not None and ticket not in self._served_tickets:
                self._resubmit(ticket, req, target)
            else:
                self.quarantined.setdefault(ticket, Quarantined(
                    req, KernelLaunchError(f"device {dev.name} evicted")))
        self._harvest(dev, out)

    def _healthiest(self, exclude: Optional[FleetDevice] = None
                    ) -> Optional[FleetDevice]:
        """The routable device with the best health score, excluding
        ``exclude`` (the device being blamed); ``None`` when no other
        device is routable — the caller quarantines instead."""
        cands = [d for d in self.routable_devices() if d is not exclude]
        return max(cands, key=lambda d: d.health, default=None)

    def _healthiest_idle(self, exclude: Optional[FleetDevice] = None
                         ) -> Optional[FleetDevice]:
        """Hedge target: healthiest routable device with nothing pending
        and nothing in flight — a hedge must never queue behind real
        work, or the duplicate finishes after the straggler it insures."""
        cands = [d for d in self.routable_devices()
                 if d is not exclude and len(d.scheduler) == 0
                 and d.scheduler.inflight_chunks == 0]
        return max(cands, key=lambda d: d.health, default=None)

    def _maybe_hedge(self) -> int:
        """Fire straggler hedges: any dependency-free member of a chunk
        in flight longer than ``hedge.after_s`` is duplicated (once per
        fleet ticket) onto the healthiest idle device. First result wins
        in ``_settle``; the loser is discarded there. Returns how many
        hedges were fired this pass."""
        hedge = self.resilience.hedge
        if hedge is None:
            return 0
        fired = 0
        now = time.monotonic()
        for dev in self.devices:
            if dev.state == "evicted":
                continue
            for chunk in dev.scheduler.inflight:
                if now - chunk.t_dispatch < hedge.after_s:
                    continue
                for req in chunk.reqs:
                    if req.deps:
                        continue
                    ticket = self._tickets.get((dev.name, req.ticket))
                    if ticket is None or ticket in self._hedged \
                            or ticket in self._served_tickets:
                        continue
                    target = self._healthiest_idle(exclude=dev)
                    if target is None:
                        return fired
                    clone = Request(req.prog, req.mem0, req.n_items,
                                    req.tag, req.priority, req.deadline_us,
                                    out_region=req.out_region,
                                    schedule=req.schedule, audit=req.audit)
                    clone.arrival_s = req.arrival_s
                    self._hedged.add(ticket)
                    local = target.scheduler.submit_request(clone)
                    # the duplicate maps to the SAME fleet ticket; the
                    # placement/_local maps keep the original so graph
                    # lookups are unaffected
                    self._tickets[(target.name, local)] = ticket
                    target.scheduler.dispatch()
                    fired += 1
        return fired

    def makespan_us(self) -> float:
        """Modeled fleet wall-clock: devices serve in parallel, so the
        slowest device's total service time bounds the trace."""
        return max(d.busy_us for d in self.devices)

    def report(self) -> dict:
        """Fleet load report: besides placement counts and modeled busy
        time, each device exposes its **utilization** (busy_us over the
        fleet makespan — 1.0 on the critical-path device, lower on
        underused ones), its live **queue depth** (pending requests plus
        dispatched-but-uncollected chunks), the modeled backlog ``eta_us``
        the router currently sees, and its physical ``shards`` width."""
        counts: Dict[str, int] = {d.name: 0 for d in self.devices}
        for name in self.placement.values():
            counts[name] += 1
        makespan = self.makespan_us()
        rep = {
            "devices": [d.name for d in self.devices],
            "placement": counts,
            "busy_us": {d.name: round(d.busy_us, 3) for d in self.devices},
            "utilization": {
                d.name: round(d.busy_us / makespan, 3) if makespan else 0.0
                for d in self.devices},
            "queue_depth": {
                d.name: len(d.scheduler) + d.scheduler.inflight_chunks
                for d in self.devices},
            "eta_us": {d.name: round(d.eta_us, 3) for d in self.devices},
            "shards": {d.name: d.scheduler.executor.shards
                       for d in self.devices},
            "makespan_us": round(self.makespan_us(), 3),
            "quarantined": sorted(self.quarantined),
        }
        if self.resilience is not None:
            rep["health"] = {d.name: round(d.health, 3)
                             for d in self.devices}
            rep["device_state"] = {d.name: d.state for d in self.devices}
            rep["faults"] = {d.name: d.faults for d in self.devices}
            rep["served"] = {d.name: d.served for d in self.devices}
            rep["reroutes"] = sum(self._reroutes.values())
            rep["hedged"] = len(self._hedged)
        return rep


def pinned_makespan(cfg: GGPUConfig,
                    trace: Sequence[Tuple[np.ndarray, np.ndarray, int]],
                    max_batch: int = 64, *, device=None) -> float:
    """Modeled wall-clock of serving the whole ``trace`` (an iterable of
    (prog, mem0, n_items)) pinned to one config on ``device`` (``None``:
    the card): the sum of per-launch service times on that device."""
    sched = Scheduler(cfg, max_batch=max_batch, device=device)
    for prog, mem0, n_items in trace:
        sched.submit(prog, mem0, n_items)
    results = sched.flush()
    return sum(r.info["cycles"] / cfg.freq_mhz for r in results)
