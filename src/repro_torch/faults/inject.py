"""The fault injector: a transparent ``Executor`` wrapper that applies a
:class:`~repro_torch.faults.plan.FaultPlan` at the dispatch boundary
(PyTorch port of ``repro.faults.inject``).

The injector sits where a fleet's ``executor_wrap`` hook puts it —
between each device's ``Scheduler`` and its real ``Executor`` — and
implements the executor protocol (``submit`` / ``chunk_ready`` /
``collect``; everything else delegates). Faults enter at exactly three
points:

  * **submit** — launches drawn for a pre-dispatch SEU get an
    ``XorBlockPatch`` merged into the chunk's staged-memory patches: the
    bit flip rides the engine's existing patch path (``bitwise_xor_`` on
    the staged buffer on the device), so it is *in* the memory the
    machine reads — not a host-side fiction. Chunks drawn as stragglers
    (or dispatched on a wedged device) are recorded in ``_holds``, with
    ``time.monotonic()`` deadlines.
  * **chunk_ready** — held chunks report not-ready until their hold
    expires (never, for a stuck device). The scheduler's readiness-
    ordered collection and the fleet's hedging both key off this.
  * **collect** — a held chunk past the executor ``timeout_s`` raises
    ``DeviceTimeout`` exactly as the real executor would; an expired
    straggler hold sleeps out its remainder and resolves normally.
    Collected results drawn for post-compute corruption get one bit of
    the collected numpy image flipped — the silent-data-corruption path
    only a checksum audit can catch.

A port dispatch returns after its chunk has retired on the device, so a
chunk is "not ready" only while a hold lasts: the holds are the only
source of timeouts and hedges.

Every decision is appended to ``injected`` — ``(kind, device, ticket,
attempt, ...)`` tuples — which is the determinism surface the fault
tests compare across runs: same seed, same plan, byte-identical log.
"""
from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np

from repro_torch.faults.plan import FaultPlan
from repro_torch.ggpu.engine import BlockPatch, XorBlockPatch
from repro_torch.serve.executors import DeviceTimeout, Executor, PendingChunk
from repro_torch.serve.request import Request, Result


class FaultInjector:
    """Wraps one device's executor with a deterministic fault plan
    (module doc). With an inactive plan every call is pure delegation
    plus one dict lookup — and ``submit`` adds nothing at all."""

    def __init__(self, name: str, executor: Executor, plan: FaultPlan):
        self.name = name
        self.inner = executor
        self.plan = plan
        self._holds: dict = {}      # id(pending) -> None (stuck) | ready-at
        self._dispatches = 0
        self.injected: List[tuple] = []   # the decision log (module doc)

    def __getattr__(self, attr):
        # transparent protocol passthrough: cfg, stats, shards, memo,
        # timeout_s, device, ... — the scheduler never knows we're here
        return getattr(self.inner, attr)

    # -- submit: pre-dispatch SEUs + hold decisions --------------------------

    def submit(self, kind: str, reqs: Sequence[Request],
               patches=None) -> PendingChunk:
        ordinal = self._dispatches
        self._dispatches += 1
        if self.plan.seu_rate:
            patches = self._merge_seu(kind, list(reqs), patches)
        pending = self.inner.submit(kind, reqs, patches)
        first = reqs[0]
        if self.plan.stuck(self.name, ordinal):
            self._holds[id(pending)] = None
            self.injected.append(("stuck", self.name, first.ticket,
                                  first.attempts, ordinal))
        elif self.plan.straggler_rate \
                and self.plan.straggler_hit(first.ticket, first.attempts):
            self._holds[id(pending)] = time.monotonic() \
                + self.plan.straggler_delay_s
            self.injected.append(("straggler", self.name, first.ticket,
                                  first.attempts, ordinal))
        return pending

    def _merge_seu(self, kind: str, reqs: List[Request], patches):
        """Fold this chunk's drawn bit flips into its staged-memory
        patches. A patch-free cohort gets one fused ``XorBlockPatch``
        (rows of zeros are no-ops for the unhit launches — one device op
        covers the chunk); everything else degrades to per-launch
        ``(lo, hi, mask, "xor")`` entries merged with whatever dependency
        patches the chunk already carries."""
        hits = {}
        for i, r in enumerate(reqs):
            if self.plan.seu_hit(r.ticket, r.attempts):
                word, bit = self.plan.seu_flip(r.ticket, r.attempts,
                                               int(r.mem0.shape[0]))
                hits[i] = (word, bit)
                self.injected.append(("seu", self.name, r.ticket,
                                      r.attempts, word, bit))
        if not hits:
            return patches
        if patches is None and kind == "cohort" and len(reqs) > 1:
            # full-width zero block with only the drawn bits set: the
            # (0, msize) span is the reference's (its compiled patch path
            # keys on it), whichever words were hit
            msize = int(reqs[0].mem0.shape[0])
            block = np.zeros((len(reqs), msize), np.int32)
            for i, (word, bit) in hits.items():
                block[i, word] = np.int32(1) << bit
            return XorBlockPatch(0, msize, block)
        per = self._per_launch(kind, reqs, patches)
        for i, (word, bit) in hits.items():
            # the same full-width span as the fused path
            mask = np.zeros(int(reqs[i].mem0.shape[0]), np.int32)
            mask[word] = np.int32(1) << bit
            entry = (0, mask.shape[0], mask, "xor")
            per[i] = (list(per[i]) + [entry]) if per[i] else [entry]
        return per

    @staticmethod
    def _per_launch(kind: str, reqs: List[Request], patches) -> list:
        """Normalize any chunk-level patch form down to one mutable
        per-launch list (the form XOR entries can always merge into)."""
        if patches is None:
            return [None] * len(reqs)
        if isinstance(patches, (BlockPatch, XorBlockPatch)):
            op = ("xor",) if isinstance(patches, XorBlockPatch) else ()
            return [[(patches.lo, patches.hi, patches.block[i]) + op]
                    for i in range(len(reqs))]
        return [list(p) if p else None for p in patches]

    # -- readiness + collection: holds, timeouts, post-compute SDC -----------

    def chunk_ready(self, pending: PendingChunk) -> bool:
        hold = self._holds.get(id(pending), False)
        if hold is None:                      # stuck: never ready
            return False
        if hold is not False and time.monotonic() < hold:
            return False                      # straggler: not yet
        return self.inner.chunk_ready(pending)

    def collect(self, pending: PendingChunk) -> List[Result]:
        key = id(pending)
        if key in self._holds:
            hold = self._holds.pop(key)
            deadline = None if self.inner.timeout_s is None \
                else pending.t_dispatch + self.inner.timeout_s
            if hold is None:
                # a wedged device only ever resolves via the timeout
                if deadline is not None:
                    time.sleep(max(0.0, deadline - time.monotonic()))
                raise DeviceTimeout(
                    f"device {self.name} stuck: chunk of "
                    f"{len(pending.reqs)} launch(es) never resolved")
            if deadline is not None and hold >= deadline:
                time.sleep(max(0.0, deadline - time.monotonic()))
                raise DeviceTimeout(
                    f"device {self.name} straggled past its "
                    f"{self.inner.timeout_s}s timeout")
            time.sleep(max(0.0, hold - time.monotonic()))
        results = self.inner.collect(pending)
        if self.plan.seu_post_rate:
            results = [self._corrupt(r, res)
                       for r, res in zip(pending.reqs, results)]
        return results

    def _corrupt(self, req: Request, res: Result) -> Result:
        """Post-compute silent corruption: flip one drawn bit of the
        collected words (no-op for cycles-only results)."""
        msize = int(np.asarray(res.mem).shape[0])
        if not msize or not self.plan.post_hit(req.ticket, req.attempts):
            return res
        word, bit = self.plan.post_flip(req.ticket, req.attempts, msize)
        mem = np.array(res.mem, np.int32, copy=True)
        mem[word] ^= np.int32(1) << bit
        self.injected.append(("sdc", self.name, req.ticket, req.attempts,
                              word, bit))
        return Result(mem, res.info)
