"""Continuous-batching scheduler: admission, chunk planning, incremental
drain, and per-launch failure quarantine (PyTorch port of
``repro.serve.scheduler``, with ``plan_waves`` for the LLM engine).

The **chunk planner** (``plan_chunks``) is the grouping pass both tenants
of the serving core share: launches of the *same kernel* (identical
program, item count, memory shape) fold into one **cohort** stepper call;
remaining launches with a matching wavefront count share one folded
**batch**; odd shapes fall back to **single** dispatch. Groups are chunked
at ``max_batch`` and ordered by (priority desc, deadline asc, earliest
ticket) — with default metadata that is exactly the legacy first-ticket
order, a pure function of the submission sequence.

The ``Scheduler`` is the continuous-batching core. ``submit`` admits a
request (optionally bounded by ``max_pending``) and returns a monotonic
ticket; ``drain(budget)`` plans over *everything currently pending* and
executes chunks until ``budget`` launches have been served, so new
submissions interleave with in-flight work instead of waiting for a full
flush. A launch that fails (hits ``max_steps``) is moved to
``quarantined`` — its chunk's survivors are re-run and still complete in
the same drain; nothing is aborted and nothing must be manually discarded.

``drain`` is **pipelined** as in the reference: it is
``dispatch(budget)`` (plan, stage and dispatch every budgeted chunk)
followed by ``collect()`` (resolve the in-flight queue in dispatch order,
quarantining failures per launch). ``max_inflight`` bounds how many
dispatched chunks may be outstanding before the oldest is collected —
the pipeline depth. Results are bit-exact with the serial path at any
depth. In the port a dispatch returns only after its chunk has retired
on the device (``repro_torch.ggpu.engine.stepper``), so the pipelined
drain does the serial drain's work and does not overlap host and device.
``Fleet`` (``repro_torch.serve.fleet``) uses the split API directly, and
its self-healing drain the incremental one (``collect_ready``,
``collect_step``, ``inflight``): there a chunk is "not ready" only while
a fault injector holds it.

The scheduler is **dependency-aware** (DESIGN.md §Kernel graphs): a
request may declare ``deps`` edges naming producer tickets whose final
memory feeds regions of its own image. Planning then works over the
topological *ready set* — a request is ready once every producer has
been **dispatched** (not collected: an in-flight producer feeds its
consumers without a collect barrier). Ready consumers are dispatched
with ``patches``: device-resident slices of
their producers' final memory (``LaunchHandle.device_mem`` /
``device_mem_block``) written into the consumer's staged buffer before
its own dispatch — a producer→consumer edge costs zero host round-trips.
A producer's handle stays **resident** (``_resident``) from its dispatch
until every consumer has been collected, so survivor re-dispatch after a
quarantine — and re-dispatch after an abandoned drain — can always
rebuild its patches. When a producer is quarantined, its consumers are
poisoned transitively: pending ones are quarantined immediately,
in-flight ones at their collection (``DependencyError`` names the failed
producer); their results are never returned.

``LaunchQueue`` remains the pre-package interface with its original
strict semantics (whole-flush raise + restore on failure); see the class
docstring. New code should use ``Scheduler``/``Fleet`` directly.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.ggpu.engine import BlockPatch, GGPUConfig, KernelLaunchError
from repro_torch.registry import SCHEDULERS
from repro_torch.serve.executors import Executor, PendingChunk
from repro_torch.serve.request import Dep, Request, Result, result_checksum


class AdmissionError(RuntimeError):
    """The scheduler's pending set is full (``max_pending`` reached)."""


class DependencyError(KernelLaunchError):
    """A launch was quarantined because a producer it depends on was —
    its input region would have been the failed producer's garbage."""


class ChecksumError(KernelLaunchError):
    """A collected result failed its request's output-checksum audit
    (``Request.audit``): the launch ran to completion but produced
    corrupted words — the silent-data-corruption failure mode an SEU
    induces. ``device_fault`` marks the *device* as suspect (the program
    is fine; a re-run elsewhere, or even here, normally passes)."""

    device_fault = True


class DeadlineExceeded(KernelLaunchError):
    """A request's wall-clock latency budget (``deadline_us``, measured
    from its admission stamp ``arrival_s``) expired before it was
    dispatched; a preemptive deadline policy drops it to quarantine
    instead of spending batch slots on a result nobody will accept."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-with-backoff for failed or corrupted launches: a
    blamed launch is re-staged and re-dispatched (with its chunk's
    survivors) up to ``max_retries`` times before quarantine;
    ``backoff_s`` sleeps ``backoff_s * attempt`` before each re-dispatch
    (linear backoff — attempt 1 waits one unit, attempt 2 two). Retries
    apply to max-steps failures, ``DeviceTimeout``, and ``ChecksumError``
    audits alike; dependency poisoning is never retried (the producer's
    output is gone for good)."""
    max_retries: int = 2
    backoff_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One planned dispatch: ``kind`` in {cohort, batch, single}, and the
    member positions into the planner's input sequence."""
    kind: str
    members: Tuple[int, ...]


def wavefronts(n_items: int, cfg: GGPUConfig) -> int:
    """Raw wavefront count — the planner's bucket key. Deliberately NOT
    the engine's ``_n_wavefronts``: that also rounds W up for ragged CU
    residency, which is a machine-shape concern — the executor's envelope
    keys use it — while grouping here must match the legacy plan
    exactly."""
    L = cfg.wavefront
    return (n_items + L - 1) // L


def plan_chunks(requests: Sequence[Request], cfg: GGPUConfig,
                max_batch: int = 64) -> List[Chunk]:
    """Grouping pass over a request sequence (see module doc). Member
    indices are positions into ``requests``; the chunk order is a pure
    function of the submission order and the requests' metadata, never of
    dict/group iteration order."""
    cohorts: Dict[tuple, List[int]] = {}
    for i, r in enumerate(requests):
        cohorts.setdefault(r.kernel_key(), []).append(i)
    chunks: List[Chunk] = []
    stragglers: List[int] = []
    for members in cohorts.values():
        if len(members) == 1:
            stragglers.append(members[0])
            continue
        for lo in range(0, len(members), max_batch):
            chunks.append(Chunk("cohort", tuple(members[lo:lo + max_batch])))
    # stragglers: vmap-batch per wavefront bucket, singles otherwise
    buckets: Dict[int, List[int]] = {}
    for i in sorted(stragglers):
        buckets.setdefault(wavefronts(requests[i].n_items, cfg), []).append(i)
    for members in buckets.values():
        for lo in range(0, len(members), max_batch):
            chunk = members[lo:lo + max_batch]
            chunks.append(Chunk("single" if len(chunk) == 1 else "batch",
                                tuple(chunk)))

    def order(c: Chunk):
        prio = max(requests[i].priority for i in c.members)
        deadline = min(requests[i].deadline_us for i in c.members)
        return (-prio, deadline, c.members[0])

    chunks.sort(key=order)
    return chunks


def plan_waves(tickets: Sequence[int], slots: int) -> List[List[int]]:
    """FIFO slot-wave admission: waves of at most ``slots`` tickets. The
    slot accounting shared by the LLM engine (decode slots) and callers
    that meter kernel submission."""
    if slots < 1:
        raise ValueError("slots must be >= 1")
    tickets = list(tickets)
    return [tickets[i:i + slots] for i in range(0, len(tickets), slots)]


@dataclasses.dataclass
class Quarantined:
    """A poisoned launch isolated by the scheduler, with its error."""
    request: Request
    error: KernelLaunchError


class Scheduler:
    """The continuous-batching core (see module doc).

    Construct from a config (the scheduler owns a private ``Executor``) or
    hand it a shared one (e.g. ``executors.get_executor`` — how the DSE
    evaluator shares executors and their memo). ``mesh`` and ``device``
    set the private executor's placement (``Executor``: a
    ``LaunchMesh`` shards each chunk's launch axis; ``device`` defaults
    to the mesh's first entry, else the card). Chunks are planned at
    ``max_batch * executor.shards`` launches. ``policy`` selects the
    chunk-planning strategy by registered name (the ``SCHEDULERS``
    registry axis; ``"cohort"`` is the legacy plan, see
    ``repro_torch.serve.policies``) or as a direct callable with the
    ``plan_chunks`` contract."""

    def __init__(self, cfg: Optional[GGPUConfig] = None, *,
                 executor: Optional[Executor] = None, max_batch: int = 64,
                 max_pending: Optional[int] = None, max_inflight: int = 8,
                 mesh=None, device=None, policy="cohort",
                 retry: Optional[RetryPolicy] = None):
        if (cfg is None) == (executor is None):
            raise ValueError("pass exactly one of cfg or executor")
        if executor is not None and (mesh is not None or device is not None):
            raise ValueError("pass mesh/device only with cfg (placement "
                             "belongs to the executor)")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.executor = executor if executor is not None \
            else Executor(cfg, mesh=mesh, device=device)
        self.cfg = self.executor.cfg
        # chunk-planning policy: a registered name (SCHEDULERS axis —
        # "cohort" is the legacy plan) or a callable with the
        # ``plan_chunks`` contract
        self.policy = policy if isinstance(policy, str) else \
            getattr(policy, "__name__", str(policy))
        self._plan = SCHEDULERS.get(policy) if isinstance(policy, str) \
            else policy
        self.max_batch = max_batch
        self.max_pending = max_pending
        self.max_inflight = max_inflight
        # bounded retry of failed/corrupted launches (None: quarantine on
        # first failure — the pre-fault-model behavior, and the default)
        self.retry = retry
        self._pending: Dict[int, Request] = {}   # ticket -> request (FIFO)
        self._next_ticket = 0
        self.quarantined: Dict[int, Quarantined] = {}
        self._completed: List[Result] = []       # buffered across failures
        self._inflight: Deque[PendingChunk] = deque()
        self._inflight_tickets: set = set()
        # dependency state (module doc): producer -> uncollected consumers,
        # producer -> (dispatched chunk, index) while any consumer waits,
        # in-flight consumer -> its quarantined producer
        self._dep_waiters: Dict[int, set] = {}
        self._resident: Dict[int, Tuple[PendingChunk, int]] = {}
        self._poisoned: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending_tickets(self) -> List[int]:
        return list(self._pending)

    @property
    def inflight_chunks(self) -> int:
        """Dispatched-but-uncollected chunks — the live pipeline depth."""
        return len(self._inflight)

    @property
    def plan_batch(self) -> int:
        """Effective planning width: ``max_batch`` launches per shard."""
        return self.max_batch * self.executor.shards

    # -- admission ----------------------------------------------------------

    def submit(self, prog: np.ndarray, mem0: np.ndarray, n_items: int,
               tag: str = "", priority: int = 0,
               deadline_us: float = math.inf,
               out_region: Optional[Tuple[int, int]] = None,
               deps: Sequence[Dep] = ()) -> int:
        """Admit a launch; returns its (monotonic) ticket. ``out_region``
        optionally declares the slice of the final memory image the caller
        wants back (``(0, 0)``: cycles-only, no download); ``deps``
        declares producer edges (module doc)."""
        return self.submit_request(Request(prog, mem0, n_items, tag,
                                           priority, deadline_us,
                                           out_region=out_region,
                                           deps=tuple(deps)))

    def submit_request(self, req: Request) -> int:
        if self.max_pending is not None \
                and len(self._pending) >= self.max_pending:
            raise AdmissionError(
                f"scheduler full: {len(self._pending)} pending "
                f"(max_pending={self.max_pending})")
        if req.deps:
            req.deps = tuple(self._resolve_dep(d) for d in req.deps)
        if req.arrival_s is None:
            # admission stamp: deadline-drop policies measure the
            # wall-clock latency budget from here
            req.arrival_s = time.monotonic()
        req.ticket = self._next_ticket
        self._next_ticket += 1
        self._pending[req.ticket] = req
        for d in req.deps:
            self._dep_waiters.setdefault(d.producer, set()).add(req.ticket)
            if d.producer in self._inflight_tickets \
                    and d.producer not in self._resident:
                # producer dispatched before it had waiters: register its
                # residency now so this consumer can be planned at once
                for chunk in self._inflight:
                    for idx, r in enumerate(chunk.reqs):
                        if r.ticket == d.producer:
                            self._resident[d.producer] = (chunk, idx)
        return req.ticket

    def _resolve_dep(self, d: Dep) -> Dep:
        """Validate one edge at admission (malformed edges bounce the
        submit, they never poison a drain) and pin its ``src`` region:
        explicit > the producer's non-empty ``out_region`` > the full
        image when the producer declared no region at all."""
        producer = self._pending.get(d.producer)
        if producer is None and d.producer in self._resident:
            chunk, idx = self._resident[d.producer]
            producer = chunk.reqs[idx]
        if producer is None:
            state = ("quarantined" if d.producer in self.quarantined
                     else "unknown or already collected")
            raise ValueError(f"dep producer ticket {d.producer} is {state}")
        src = d.src
        if src is None:
            if producer.out_region is None:
                src = (0, producer.mem0.shape[0])
            elif producer.out_region[1] > producer.out_region[0]:
                src = producer.out_region
            else:
                raise ValueError(
                    f"dep on producer ticket {d.producer} needs an explicit "
                    "src: the producer declares the empty out_region (0, 0)")
        if not (0 <= src[0] <= src[1] <= producer.mem0.shape[0]):
            raise ValueError(f"dep src {src} outside producer ticket "
                             f"{d.producer}'s memory image "
                             f"[0, {producer.mem0.shape[0]})")
        if src[1] - src[0] != d.dst[1] - d.dst[0]:
            raise ValueError(f"dep src {src} and dst {d.dst} widths differ")
        return Dep(d.producer, d.dst, src)

    def cancel(self, ticket: int) -> Request:
        """Remove a still-pending request by ticket. A request that is in
        flight or has consumers waiting on it cannot be cancelled."""
        if ticket in self._inflight_tickets:
            raise ValueError(f"ticket {ticket} is in flight")
        if self._dep_waiters.get(ticket):
            raise ValueError(f"ticket {ticket} has waiting consumers")
        req = self._pending.pop(ticket)
        self._release_deps(req)
        return req

    # -- drain --------------------------------------------------------------

    def _ready(self) -> List[Request]:
        """The planner's input: pending, not in flight, every producer
        already dispatched (resident) — the topological ready set."""
        return [r for r in self._pending.values()
                if r.ticket not in self._inflight_tickets
                and all(d.producer in self._resident for d in r.deps)]

    def dispatch(self, budget: Optional[int] = None) -> int:
        """Plan chunks over the ready set (pending, not in flight, every
        producer dispatched) and dispatch them until ``budget`` launches
        have been staged (``None``: everything); returns how many launches
        were dispatched (each chunk has retired when its dispatch returns:
        module doc). When more than ``max_inflight`` chunks are
        outstanding the oldest is collected (into the completed buffer) to
        bound the pipeline. Dispatching a producer makes its consumers
        ready, so planning repeats until no progress — a whole DAG drains
        in one call, producers feeding in-flight consumers with no collect
        barrier in between."""
        taken = 0
        while budget is None or taken < budget:
            items = self._ready()
            chunks = self._plan(items, self.cfg, self.plan_batch)
            progress = False
            for chunk in chunks:
                if budget is not None and taken >= budget:
                    break
                if chunk.kind == "drop":
                    # a preemptive policy (e.g. "deadline-drop") planned
                    # these members out of the batch: quarantine them with
                    # DeadlineExceeded instead of dispatching — they count
                    # against the budget (taken off the queue) but never
                    # occupy a device
                    for r in (items[i] for i in chunk.members):
                        if r.ticket in self._pending \
                                and r.ticket not in self._inflight_tickets:
                            taken += 1
                            self._quarantine(r, DeadlineExceeded(
                                f"ticket {r.ticket} missed its "
                                f"{r.deadline_us}us deadline before "
                                f"dispatch"))
                            progress = True
                    continue
                try:
                    # shrink the window BEFORE dispatching so
                    # ``max_inflight`` bounds simultaneous in-flight
                    # chunks: 1 = strictly serial (collect each chunk
                    # before the next is staged — the sync reference),
                    # N = an N-deep dispatch-ahead pipeline
                    while len(self._inflight) >= self.max_inflight:
                        self._collect_oldest()
                    # the window collection above may have quarantined a
                    # planned-but-undispatched consumer (cascade): keep
                    # only members that are still live
                    reqs = [r for r in (items[i] for i in chunk.members)
                            if r.ticket in self._pending
                            and r.ticket not in self._inflight_tickets]
                    if not reqs:
                        continue
                    taken += len(reqs)
                    pending = self.executor.submit(
                        chunk.kind, reqs,
                        self._chunk_patches(reqs))
                    self._inflight.append(pending)
                    self._inflight_tickets.update(r.ticket for r in reqs)
                    self._note_dispatched(pending)
                    progress = True
                except BaseException:
                    self._abandon_inflight()
                    raise
            if not progress:
                break
        return taken

    def _note_dispatched(self, pending: PendingChunk) -> None:
        """Record residency for dispatched requests that have consumers
        waiting: the handle (and with it the device-side final memory)
        stays reachable until every consumer has been collected."""
        for idx, r in enumerate(pending.reqs):
            if self._dep_waiters.get(r.ticket):
                self._resident[r.ticket] = (pending, idx)

    def _chunk_patches(self, reqs: Sequence[Request]):
        """Build the device-resident patches for one planned chunk: the
        fused ``BlockPatch`` when every member draws the same region from
        producers co-located in one resident chunk (one device op feeds
        the whole chunk), per-launch patch lists otherwise, ``None`` when
        the chunk has no dependencies."""
        if not any(r.deps for r in reqs):
            return None
        fused = self._fused_patch(reqs)
        if fused is not None:
            return fused
        per = []
        for r in reqs:
            plist = []
            for d in r.deps:
                chunk, idx = self._resident[d.producer]
                plist.append((d.dst[0], d.dst[1],
                              chunk.handle.device_mem(idx, d.src)))
            per.append(plist or None)
        return per

    def _fused_patch(self, reqs: Sequence[Request]):
        """The chunk-to-chunk fast path: every member has exactly one dep,
        all with identical (dst, src) regions, and every producer lives in
        the same resident chunk — one fused slice of the producer chunk's
        memory feeds the whole consumer chunk."""
        if not all(len(r.deps) == 1 for r in reqs):
            return None
        d0 = reqs[0].deps[0]
        if not all(r.deps[0].dst == d0.dst and r.deps[0].src == d0.src
                   for r in reqs):
            return None
        entries = [self._resident[r.deps[0].producer] for r in reqs]
        chunk0 = entries[0][0]
        if any(e[0] is not chunk0 for e in entries):
            return None
        block = chunk0.handle.device_mem_block(*d0.src)
        idxs = [e[1] for e in entries]
        if idxs != list(range(len(chunk0.reqs))):
            block = block.index_select(
                0, torch.as_tensor(idxs, device=block.device))
        return BlockPatch(d0.dst[0], d0.dst[1], block)

    def collect(self) -> List[Result]:
        """Resolve every in-flight chunk (dispatch order) and return all
        results completed since the last collection, in ticket order;
        poisoned launches land in ``quarantined``."""
        try:
            while self._inflight:
                self._collect_oldest()
        except BaseException:
            self._abandon_inflight()
            raise
        out, self._completed = self._completed, []
        out.sort(key=lambda r: r.info["ticket"])
        return out

    # -- incremental collection (the fleet resilience surface) --------------

    @property
    def inflight(self) -> Tuple[PendingChunk, ...]:
        """The dispatched-but-uncollected chunks, oldest first — the
        read-only view a fleet's hedging policy scans for stragglers."""
        return tuple(self._inflight)

    def oldest_dispatch(self) -> float:
        """Dispatch wall clock of the oldest in-flight chunk (``inf``
        when nothing is in flight)."""
        return self._inflight[0].t_dispatch if self._inflight \
            else math.inf

    def _resolvable(self, pending: PendingChunk) -> bool:
        """Would collecting this chunk return without waiting on the
        device? True when the device has finished it, or when it is
        already past the executor timeout (collecting then raises
        ``DeviceTimeout`` immediately — also no wait)."""
        if self.executor.chunk_ready(pending):
            return True
        t = getattr(self.executor, "timeout_s", None)
        return t is not None \
            and time.monotonic() - pending.t_dispatch >= t

    def collect_ready(self) -> List[Result]:
        """Resolve only the in-flight chunks that are already finished
        (or past the executor timeout), never blocking on the rest —
        the readiness-ordered collection a resilient fleet drains with,
        so one straggling device never serializes the others'
        collections. Returns the results completed by this call, ticket
        order; unfinished chunks keep their relative (dispatch) order."""
        try:
            for _ in range(len(self._inflight)):
                if self._resolvable(self._inflight[0]):
                    self._collect_oldest()
                else:
                    self._inflight.rotate(-1)
        except BaseException:
            self._abandon_inflight()
            raise
        out, self._completed = self._completed, []
        out.sort(key=lambda r: r.info["ticket"])
        return out

    def collect_step(self) -> List[Result]:
        """Blocking-collect the single oldest in-flight chunk — the
        guaranteed-progress move a resilient fleet makes when nothing is
        resolvable anywhere. Returns the results it completed."""
        if not self._inflight:
            return []
        try:
            self._collect_oldest()
        except BaseException:
            self._abandon_inflight()
            raise
        out, self._completed = self._completed, []
        out.sort(key=lambda r: r.info["ticket"])
        return out

    def drain(self, budget: Optional[int] = None) -> List[Result]:
        """Serve pending work: plan chunks over the current pending set and
        execute them in planned order until ``budget`` launches have been
        taken off the queue (``None``: everything) — dispatching ahead of
        collection (see ``dispatch``/``collect``). Returns the completed
        ``Result``s of this call in ticket order; poisoned launches land in
        ``quarantined`` (they count against the budget but produce no
        result). Per-launch results are bit-exact with direct
        ``run_kernel`` regardless of how submissions interleave with
        drains or how deep the pipeline runs.

        Unexpected failures (anything other than a launch hitting
        ``max_steps``) propagate, but lose no work: requests leave
        ``_pending`` only when they complete or are quarantined, in-flight
        chunks are abandoned back to pending, and completed results are
        buffered on the scheduler until a drain returns — so after an
        interrupt or a malformed launch, the next ``drain`` resumes with
        everything still queued plus the results already computed."""
        self.dispatch(budget)
        return self.collect()

    def flush(self) -> List[Result]:
        """Monolithic drain of everything pending."""
        return self.drain()

    def _abandon_inflight(self) -> None:
        """Drop in-flight chunks after an unexpected failure: their
        requests are still pending, so the next dispatch re-plans them —
        no work is lost, nothing is double-served. Residency entries
        pointing into the abandoned chunks are dropped with them (the
        producers re-dispatch and re-register); entries for
        already-collected producers survive, so abandoned consumers can
        rebuild their patches on re-dispatch. In-flight consumers of a
        quarantined producer go straight to quarantine — their producer's
        output is gone for good."""
        abandoned = {id(c) for c in self._inflight}
        self._inflight.clear()
        self._inflight_tickets.clear()
        self._resident = {t: e for t, e in self._resident.items()
                          if id(e[0]) not in abandoned}
        poisoned, self._poisoned = self._poisoned, {}
        for ticket, producer in poisoned.items():
            req = self._pending.get(ticket)
            if req is not None:
                self._quarantine(req, DependencyError(
                    f"producer ticket {producer} was quarantined"))

    def _collect_oldest(self) -> None:
        pending = self._inflight.popleft()
        for r in pending.reqs:
            self._inflight_tickets.discard(r.ticket)
        self._completed.extend(self._collect_quarantining(pending))

    def _release_deps(self, req: Request) -> None:
        """A consumer reached a terminal state: stop holding its
        producers' handles resident once no consumer still waits."""
        for d in req.deps:
            waiters = self._dep_waiters.get(d.producer)
            if waiters is None:
                continue
            waiters.discard(req.ticket)
            if not waiters:
                del self._dep_waiters[d.producer]
                self._resident.pop(d.producer, None)

    def _quarantine(self, req: Request,
                    exc: KernelLaunchError) -> None:
        """Isolate one launch and poison its consumers transitively:
        pending consumers are quarantined right here, in-flight ones at
        their own collection (their result is garbage — the patch read the
        failed producer's memory)."""
        self._pending.pop(req.ticket, None)
        self.quarantined[req.ticket] = Quarantined(req, exc)
        self._release_deps(req)
        waiters = self._dep_waiters.pop(req.ticket, set())
        self._resident.pop(req.ticket, None)
        for ticket in waiters:
            if ticket in self._poisoned:
                continue
            if ticket in self._inflight_tickets:
                self._poisoned[ticket] = req.ticket
            elif ticket in self._pending:
                self._quarantine(self._pending[ticket], DependencyError(
                    f"producer ticket {req.ticket} was quarantined"))

    def _retryable(self, req: Request, exc: KernelLaunchError) -> bool:
        """May this blamed launch be re-staged and re-dispatched? Only
        under a retry policy with budget left, never for dependency
        poisoning (the producer's output is gone), and only while every
        producer it needs is still resident (its patches can be
        rebuilt)."""
        if self.retry is None or req.attempts >= self.retry.max_retries:
            return False
        if isinstance(exc, DependencyError) or req.ticket in self._poisoned:
            return False
        return all(d.producer in self._resident for d in req.deps)

    def _backoff(self, attempt: int) -> None:
        if self.retry is not None and self.retry.backoff_s:
            time.sleep(self.retry.backoff_s * max(1, attempt))

    def _collect_quarantining(self, pending: PendingChunk) -> List[Result]:
        """Collect one chunk; on failure isolate the blamed launch(es)
        and re-dispatch the survivors until the chunk completes. Survivor
        results stay bit-exact: cohort/batch folding is per-launch exact
        at any membership, and survivors with dependencies rebuild their
        patches from the still-resident producer handles (a consumer in
        flight keeps its producers resident, so the rebuild always finds
        them).

        Under a ``RetryPolicy``, a blamed launch with retry budget left is
        *re-staged and re-dispatched with the survivors* instead of
        quarantined (its ``attempts`` counter moves) — this covers
        max-steps failures, whole-chunk ``DeviceTimeout``
        (``exc.index is None``: every member is blamed), and the
        per-result output-checksum audit: a result whose words fail
        ``Request.audit`` is never returned, it is retried or quarantined
        as a ``ChecksumError``. Without a policy the behavior is the
        original quarantine-on-first-failure, unchanged."""
        out: List[Result] = []
        while True:
            reqs = pending.reqs
            try:
                results = self.executor.collect(pending)
            except KernelLaunchError as exc:
                idx = getattr(exc, "index", 0)
                blamed = list(reqs) if idx is None else [reqs[idx]]
                keep = []
                for bad in blamed:
                    if self._retryable(bad, exc):
                        bad.attempts += 1
                        keep.append(bad)
                    else:
                        self._poisoned.pop(bad.ticket, None)
                        self._quarantine(bad, exc)
                if keep:
                    self._backoff(max(r.attempts for r in keep))
                survivors = [r for r in reqs
                             if r.ticket in self._pending
                             and r.ticket not in self.quarantined]
                if not survivors:
                    return out
                pending = self.executor.submit(
                    pending.kind, survivors, self._chunk_patches(survivors))
                self._note_dispatched(pending)
                continue
            redo: List[Request] = []
            for req, res in zip(reqs, results):
                producer = self._poisoned.pop(req.ticket, None)
                if producer is not None:
                    self._quarantine(req, DependencyError(
                        f"producer ticket {producer} was quarantined"))
                    continue
                if req.audit is not None \
                        and result_checksum(res.mem) != req.audit:
                    exc = ChecksumError(
                        f"ticket {req.ticket} failed its output-checksum "
                        f"audit (attempt {req.attempts + 1})")
                    if self._retryable(req, exc):
                        req.attempts += 1
                        redo.append(req)
                    else:
                        self._quarantine(req, exc)
                    continue
                res.info["ticket"] = req.ticket
                if req.tag:
                    res.info["tag"] = req.tag
                del self._pending[req.ticket]
                self._release_deps(req)
                out.append(res)
            if not redo:
                return out
            self._backoff(max(r.attempts for r in redo))
            pending = self.executor.submit(
                pending.kind if len(redo) > 1 else "single", redo,
                self._chunk_patches(redo))
            self._note_dispatched(pending)


class LaunchQueue:
    """Multi-kernel launch queue for the G-GPU simulator (the pre-package
    interface, bit-exact compatible).

    ``submit`` enqueues a (program, mem-image, n_items) launch and returns
    a ticket; ``flush`` executes everything queued and returns results in
    submission order. Launches of the *same kernel* (identical program,
    item count, and memory shape — the serving-traffic common case) are
    folded into one **cohort** stepper call, which amortizes the
    simulator's per-round fixed costs across the whole group; remaining
    launches with a matching wavefront count share one vmapped batch, and
    odd shapes fall back to the single-launch path. Groups are chunked at
    ``max_batch`` and drained deterministically in ticket order (each
    chunk executes in order of its earliest submission — never in dict or
    group-iteration order). All three paths are bit-exact per launch.

    Failure semantics are the legacy strict mode: if any launch fails
    (e.g. hits ``max_steps``), the whole flush raises a
    ``KernelLaunchError`` naming the poisoned launch's ticket and tag, and
    every launch is restored to the queue so the caller can ``discard``
    that ticket and retry the rest. ``Scheduler`` supersedes this with
    per-launch quarantine and incremental ``drain``.
    """

    def __init__(self, cfg: GGPUConfig, max_batch: int = 64, *,
                 device=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.cfg = cfg
        self.max_batch = max_batch
        self.executor = Executor(cfg, device=device)
        self._pending: List[Request] = []

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, prog: np.ndarray, mem0: np.ndarray, n_items: int,
               tag: str = "") -> int:
        """Queue a launch; returns its ticket (index into flush() order)."""
        self._pending.append(Request(prog, mem0, n_items, tag))
        return len(self._pending) - 1

    def discard(self, ticket: int) -> Request:
        """Remove and return a pending launch by its current ticket (the
        recovery path after a failed flush: drop the poisoned launch,
        flush the rest). Later tickets shift down by one."""
        return self._pending.pop(ticket)

    def _plan_chunks(self, pending: List[Request]
                     ) -> List[Tuple[str, List[int]]]:
        """Legacy-shaped view of the shared planner (kind, tickets)."""
        return [(c.kind, list(c.members))
                for c in plan_chunks(pending, self.cfg, self.max_batch)]

    def flush(self) -> List[Result]:
        """Run every queued launch; results come back in submission order
        with the queue's grouping recorded in ``info['batch_size']`` and
        the submission ``tag`` (if any) in ``info['tag']``."""
        pending, self._pending = self._pending, []
        try:
            return self._run_all(pending)
        except BaseException:
            self._pending = pending + self._pending
            raise

    def _run_all(self, pending: List[Request]) -> List[Result]:
        results: List[Optional[Result]] = [None] * len(pending)

        def blame(chunk, exc: KernelLaunchError):
            """Re-raise a chunk failure naming the submission ticket."""
            ticket = chunk[exc.index]
            tag = pending[ticket].tag
            raise KernelLaunchError(
                f"launch ticket {ticket}" + (f" (tag {tag!r})" if tag
                                             else "")
                + f" hit max_steps without halting; discard({ticket}) "
                f"and flush() again to retry the rest", ticket) from exc

        for kind, chunk in self._plan_chunks(pending):
            try:
                outs = self.executor.run(kind, [pending[i] for i in chunk])
            except KernelLaunchError as exc:
                blame(chunk, exc)
            for i, out in zip(chunk, outs):
                results[i] = out
        for i, req in enumerate(pending):
            results[i].info["ticket"] = i
            if req.tag:
                results[i].info["tag"] = req.tag
        return results  # type: ignore[return-value]
