"""Preemptive deadline-drop scheduling policy — a drop-in plugin (the
port's copy of the reference's plugin of the same name).

``deadline-drop`` is the admission-control variant of the cohort
planner: before planning, every pending request whose *wall-clock*
latency budget has already expired is planned into a leading ``"drop"``
chunk — the scheduler quarantines those members with
``DeadlineExceeded`` instead of spending batch slots computing results
nobody will accept — and the survivors are planned exactly as the
default ``cohort`` policy would plan them.

The budget is ``Request.deadline_us`` interpreted as *microseconds of
wall clock since admission* (the ``arrival_s`` stamp the scheduler
writes at ``submit_request``). Requests with no deadline (``inf``, the
default) or no admission stamp are never dropped, so traffic that
doesn't opt in is planned identically to ``cohort`` — including the
(priority, deadline, ticket) chunk ordering, which still sees the
deadline as its EDF tie-break.

Registered here, the policy resolves everywhere a policy name does
(``Scheduler(policy="deadline-drop")``, ``Fleet(policy=...)``) and
joins the registry smoke with no other edit.
"""
from __future__ import annotations

import math
import time
from typing import List, Sequence

from repro_torch.registry import SCHEDULERS
from repro_torch.serve.scheduler import Chunk, plan_chunks


@SCHEDULERS.register("deadline-drop")
def plan_deadline_drop(requests: Sequence, cfg,
                       max_batch: int = 64) -> List[Chunk]:
    """Cohort planning with preemptive expiry (module doc): expired
    requests lead in one ``"drop"`` chunk, survivors get the default
    plan (member indices remapped back into ``requests``)."""
    now = time.monotonic()
    expired, alive = [], []
    for i, r in enumerate(requests):
        if r.deadline_us != math.inf and r.arrival_s is not None \
                and (now - r.arrival_s) * 1e6 > r.deadline_us:
            expired.append(i)
        else:
            alive.append(i)
    chunks: List[Chunk] = []
    if expired:
        chunks.append(Chunk("drop", tuple(expired)))
    for c in plan_chunks([requests[i] for i in alive], cfg, max_batch):
        chunks.append(Chunk(c.kind, tuple(alive[j] for j in c.members)))
    return chunks
