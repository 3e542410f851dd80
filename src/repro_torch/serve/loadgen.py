"""Trace-driven open-loop load generator for the serving stack (PyTorch
port of ``repro.serve.loadgen``: numpy draws identical to the
reference's, wall clock on the host).

Closed-loop benchmarking (submit a burst, drain, repeat — what
a throughput benchmark measures) can only see *capacity*; it never observes
queueing, because the client politely waits. Tail latency under real
traffic needs an **open-loop** driver: arrivals happen at predetermined
wall-clock times whether or not the server has kept up, so backlog and
the p99 it produces are properties of the *offered load*, exactly as in
production serving studies.

Two arrival processes, both deterministic under a fixed seed:

  * ``poisson_arrivals`` — memoryless inter-arrival gaps at ``rate_hz``,
    the standard open-loop model.
  * ``bursty_arrivals`` — bursts of simultaneous arrivals whose start
    times are themselves Poisson, the adversarial shape for a
    continuous-batching scheduler (all-at-once admission, then silence).

``replay`` drives any target with the ``submit_request``/``drain``
protocol (``Scheduler`` and ``Fleet`` both) from an arrival trace:
requests are admitted the moment their arrival time passes, the target
is drained opportunistically between arrivals, and each completion is
stamped with the wall clock. A request's **latency** is completion wall
time minus its *scheduled* arrival — admission or queueing delay counts
against the server, as it should in an open-loop harness. The returned
``LoadResult`` reports p50/p99/mean latency and the sustained service
rate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.registry import TRAFFIC
from repro_torch.serve.request import Request

__all__ = ["poisson_arrivals", "bursty_arrivals", "replay", "LoadResult"]


def poisson_arrivals(rate_hz: float, n: int, seed: int = 0) -> np.ndarray:
    """``n`` arrival times (seconds from trace start) with exponential
    inter-arrival gaps at mean rate ``rate_hz``. Deterministic per seed."""
    if rate_hz <= 0:
        raise ValueError("rate_hz must be > 0")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_hz, int(n)))


def bursty_arrivals(n_bursts: int, burst: int, gap_s: float,
                    seed: int = 0) -> np.ndarray:
    """``n_bursts`` bursts of ``burst`` simultaneous arrivals; burst start
    times are Poisson with mean spacing ``gap_s``. Deterministic per
    seed."""
    if gap_s <= 0:
        raise ValueError("gap_s must be > 0")
    rng = np.random.default_rng(seed)
    starts = np.cumsum(rng.exponential(gap_s, int(n_bursts)))
    return np.repeat(starts, int(burst))


# -- registry plugins --------------------------------------------------------
# The TRAFFIC axis contract is the *normalized* generator signature
# ``(n, seed=0) -> arrivals`` so sweeps can drive any registered
# pattern interchangeably; the raw parameterized functions above stay the
# API for callers that tune rates/shapes themselves.

@TRAFFIC.register("poisson")
def poisson_traffic(n: int, seed: int = 0,
                    rate_hz: float = 200.0) -> np.ndarray:
    """Registry adapter: memoryless arrivals at a fixed default rate."""
    return poisson_arrivals(rate_hz, n, seed)


@TRAFFIC.register("bursty")
def bursty_traffic(n: int, seed: int = 0, burst: int = 8,
                   gap_s: float = 0.004) -> np.ndarray:
    """Registry adapter: all-at-once bursts, trimmed to exactly ``n``
    arrivals (the adversarial shape for continuous batching)."""
    n_bursts = -(-int(n) // burst)
    return bursty_arrivals(n_bursts, burst, gap_s, seed)[:int(n)]


@dataclasses.dataclass
class LoadResult:
    """Outcome of one open-loop replay (latencies in seconds, aligned
    with the arrival trace; ``nan`` marks a quarantined request)."""
    arrivals: np.ndarray
    latencies: np.ndarray
    duration_s: float
    served: int
    quarantined: int

    def _pct(self, q: float) -> float:
        lat = self.latencies[~np.isnan(self.latencies)]
        return float(np.percentile(lat, q)) if lat.size else float("nan")

    @property
    def p50_ms(self) -> float:
        return self._pct(50) * 1e3

    @property
    def p99_ms(self) -> float:
        return self._pct(99) * 1e3

    @property
    def mean_ms(self) -> float:
        lat = self.latencies[~np.isnan(self.latencies)]
        return float(lat.mean()) * 1e3 if lat.size else float("nan")

    @property
    def rate_per_s(self) -> float:
        """Sustained service rate over the whole replay."""
        return self.served / self.duration_s if self.duration_s else 0.0

    def report(self) -> dict:
        return {
            "served": self.served,
            "quarantined": self.quarantined,
            "duration_s": round(self.duration_s, 6),
            "rate_per_s": round(self.rate_per_s, 3),
            "p50_ms": round(self.p50_ms, 4),
            "p99_ms": round(self.p99_ms, 4),
            "mean_ms": round(self.mean_ms, 4),
        }


def replay(target, arrivals: Sequence[float],
           make_request: Callable[[int], Request],
           drain_budget: Optional[int] = None) -> LoadResult:
    """Open-loop replay of an arrival trace against ``target`` (anything
    with ``submit_request(req) -> ticket``, ``drain(budget)``, and a
    ``quarantined`` dict — ``Scheduler`` or ``Fleet``).

    ``make_request(i)`` builds the request for arrival ``i`` (trace
    order). Arrivals are admitted as their times pass; between arrivals
    the target is drained with ``drain_budget`` launches per call
    (``None``: everything pending), which bounds how long a drain can
    hold off a due admission. Latency for arrival ``i`` is completion
    wall time minus ``arrivals[i]``."""
    arrivals = np.asarray(arrivals, dtype=float)
    n = arrivals.size
    order = np.argsort(arrivals, kind="stable")
    latencies = np.full(n, np.nan)
    ticket_of: Dict[int, int] = {}          # target ticket -> arrival index
    done = 0
    seen_quarantined: set = set()
    t0 = time.perf_counter()

    def settle(results: List) -> int:
        nonlocal done
        now = time.perf_counter() - t0
        mono = time.monotonic()
        for res in results:
            i = ticket_of[res.info["ticket"]]
            if not np.isnan(latencies[i]):
                continue  # already settled (a resilient target may hedge)
            # a resilient fleet stamps when the result actually settled
            # inside its drain; back the completion time up by that age
            # so a drain that kept polling (e.g. waiting out a straggler)
            # does not inflate everyone else's measured latency
            age = mono - res.info.get("settled_s", mono)
            latencies[i] = (now - age) - arrivals[i]
            done += 1
        for tk in target.quarantined:
            if tk in ticket_of and tk not in seen_quarantined:
                seen_quarantined.add(tk)
                done += 1
        return len(results)

    next_up = 0
    while done < n:
        now = time.perf_counter() - t0
        while next_up < n and arrivals[order[next_up]] <= now:
            i = int(order[next_up])
            ticket_of[target.submit_request(make_request(i))] = i
            next_up += 1
        if len(ticket_of) > done:
            settle(target.drain(drain_budget))
        elif next_up < n:
            # idle until the next arrival is due (capped so a coarse
            # sleep never delays admission noticeably)
            wait = arrivals[order[next_up]] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 5e-4))
    duration = time.perf_counter() - t0
    return LoadResult(arrivals=arrivals, latencies=latencies,
                      duration_s=duration, served=done - len(seen_quarantined),
                      quarantined=len(seen_quarantined))
