"""Chunk-planning policies — the ``SCHEDULERS`` registry axis built-ins
(PyTorch port of ``repro.serve.policies``).

A policy is a callable ``(requests, cfg, max_batch) -> List[Chunk]``
(the contract of ``scheduler.plan_chunks``): it groups the ready set
into cohort/batch/single dispatches and fixes their execution order.
``Scheduler(policy="name")`` resolves the name through the registry, so
a new policy is one registered callable (or one drop-in file under
``repro_torch/registry/plugins/``, as ``deadline-drop`` is).

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
from repro_torch.registry import SCHEDULERS
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Chunk, plan_chunks

SCHEDULERS.register("cohort", plan_chunks)


@SCHEDULERS.register("fifo")
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

