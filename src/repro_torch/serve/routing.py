"""Fleet routing strategies — the ``ROUTERS`` registry axis built-ins
(PyTorch port of ``repro.serve.routing``; pure Python).

A router is a *class*; ``Fleet(router="name")`` resolves the name
through the registry and instantiates one router per fleet (routers may
carry state — ``round-robin`` does). The instance contract is::

    pick(fleet, req) -> FleetDevice

called for every dependency-free submission (requests with ``deps`` are
always pinned to their producers' device, regardless of router — device
residency of graph edges is a correctness property, not a policy).
Routers read the fleet's public estimate surface (``finish_us``,
``estimate_us``, ``routable_devices``) and must not mutate fleet state:
the fleet itself charges the backlog after the pick. Under a
:class:`~repro_torch.serve.fleet.FleetResilience` policy ``routable_devices``
excludes evicted devices (and probation devices out of admission
budget), so every router heals around a retired device for free.

Built-ins:

  * ``earliest-finish`` — the default greedy placement: minimize
    (shard-width-discounted backlog + estimated service time); the
    pre-registry behavior, placement-exact.
  * ``round-robin`` — cycle through devices in order, ignoring load and
    service estimates. The baseline that shows what the learned
    estimates buy; also the fairness floor when estimates are known to
    be garbage (e.g. adversarial traffic of never-seen kernels).
"""
from __future__ import annotations

from repro_torch.registry import ROUTERS


@ROUTERS.register("earliest-finish")
class EarliestFinishRouter:
    """Greedy earliest-finish-time placement (see module doc)."""

    def pick(self, fleet, req):
        return min(fleet.routable_devices(),
                   key=lambda d: fleet.finish_us(d, req))


@ROUTERS.register("round-robin")
class RoundRobinRouter:
    """Stateful cyclic placement, blind to load and estimates."""

    def __init__(self):
        self._next = 0

    def pick(self, fleet, req):
        devices = fleet.routable_devices()
        dev = devices[self._next % len(devices)]
        self._next += 1
        return dev
