"""Chunk-planning policies (PyTorch port of ``repro.serve.policies``).

A policy is a callable ``(requests, cfg, max_batch) -> List[Chunk]``
(the contract of ``scheduler.plan_chunks``): it groups the ready set
into cohort/batch/single dispatches and fixes their execution order.
``Scheduler(policy="name")`` resolves the name here. The reference
registers its policies on the ``SCHEDULERS`` registry axis; the port has
no registry yet (ROADMAP.md, queue 1, item 8), so it keeps this map.

  * ``cohort`` — the default continuous-batching plan
    (``plan_chunks``): same-kernel cohort folding, wavefront-bucketed
    batches, ordered by (priority desc, deadline asc, first ticket).
  * ``fifo`` — strict submission order: only *adjacent* same-kernel
    runs fold into cohorts, nothing is reordered across submission
    ticks.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.ggpu.engine import GGPUConfig
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Chunk, plan_chunks


def plan_fifo(requests: Sequence[Request], cfg: GGPUConfig,
              max_batch: int = 64) -> List[Chunk]:
    """Strict-FIFO plan: walk the submission order, folding only
    *consecutive* launches of the same kernel into cohorts (capped at
    ``max_batch``); everything else dispatches as singles, in order.
    Priorities and deadlines are ignored — the policy's contract is that
    completion order is admission order."""
    chunks: List[Chunk] = []
    run: List[int] = []

    def close_run():
        if not run:
            return
        kind = "cohort" if len(run) > 1 else "single"
        for lo in range(0, len(run), max_batch):
            part = run[lo:lo + max_batch]
            chunks.append(Chunk(kind if len(part) > 1 else "single",
                                tuple(part)))
        run.clear()

    prev_key = None
    for i, r in enumerate(requests):
        key = r.kernel_key()
        if key != prev_key:
            close_run()
            prev_key = key
        run.append(i)
    close_run()
    return chunks


POLICIES = {"cohort": plan_chunks, "fifo": plan_fifo}


def get_policy(name: str):
    """The plan called ``name`` (KeyError naming the choices)."""
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown scheduling policy {name!r}; "
                       f"choices: {sorted(POLICIES)}") from None
