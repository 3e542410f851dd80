"""Slot-wave admission (``plan_waves`` of the port's
``repro.serve.scheduler``)."""
from __future__ import annotations

from typing import List, Sequence


def plan_waves(tickets: Sequence[int], slots: int) -> List[List[int]]:
    """FIFO slot-wave admission: waves of at most ``slots`` tickets."""
    if slots < 1:
        raise ValueError("slots must be >= 1")
    tickets = list(tickets)
    return [tickets[i:i + slots] for i in range(0, len(tickets), slots)]
