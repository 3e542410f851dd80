"""Spans, calls and the device trace of a traced run.

``Spans`` keeps, in memory, each span's label and host interval
(``time.perf_counter_ns``) and, where asked on a card, its device
interval between two CUDA events recorded on the current stream (no
sync is added: the events are read once the run's waves are done); off
a card its host interval stands in. A span's parent is the innermost span open when it starts. ``call`` keeps
what a call was given.

``DeviceTrace`` runs ``torch.profiler`` over the window, tracing device
activity alone, and reads every device operation's name and interval
from the raw trace. It aligns the device clock to the host's with one
marker operation launched while the device is idle, so that each idle
gap can be labelled by the host span it fell in.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


class Spans:
    def __init__(self, device: torch.device):
        self.on_card = device.type == "cuda"
        self.host: List[Tuple[str, int, int, Optional[str]]] = []
        self._events: List[Tuple[str, object, object, Optional[str]]] = []
        self.device_ms: Dict[str, List[Tuple[float, Optional[str]]]] = \
            defaultdict(list)
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self._open: List[str] = []

    @contextlib.contextmanager
    def span(self, label: str, device: bool = False):
        parent = self._open[-1] if self._open else None
        ev = None
        if device and self.on_card:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter_ns()
        self._open.append(label)
        try:
            yield
        finally:
            self._open.pop()
            t1 = time.perf_counter_ns()
            self.host.append((label, t0, t1, parent))
            if ev is not None:
                ev[1].record()
                self._events.append((label, ev[0], ev[1], parent))
            elif device:
                self.device_ms[label].append(((t1 - t0) / 1e6, parent))

    def call(self, label: str, args: dict) -> None:
        self.calls[label].append(args)

    def settle(self) -> None:
        """Read the device spans recorded so far (after a sync)."""
        for label, a, b, parent in self._events:
            self.device_ms[label].append((a.elapsed_time(b), parent))
        self._events.clear()

    def ms(self, label: str, parent: Optional[str] = "*") -> List[float]:
        """Device ms of every ``label`` span (whose parent is ``parent``
        unless that is "*")."""
        return [ms for ms, p in self.device_ms.get(label, [])
                if parent == "*" or p == parent]


class DeviceTrace:
    """``torch.profiler`` over a window (module doc)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.ops: List[Tuple[str, int, int]] = []   # (name, start, end) ns
        self.offset_ns = 0                          # device - host clock

    def start(self) -> None:
        self._prof.start()
        torch.cuda.synchronize()
        self._host_mark = time.perf_counter_ns()
        torch.ones(1, device="cuda").mul_(2)           # the marker
        torch.cuda.synchronize()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.stop()
        evs = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in self._prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA),
                     key=lambda x: x[1])
        # the first two device operations are the marker's fill and mul
        if len(evs) < 2 or "fill" not in evs[0][0].lower():
            raise RuntimeError("the device trace does not start with the "
                               "clock marker: " + repr(evs[:2]))
        self.offset_ns = evs[0][1] - self._host_mark
        self.ops = evs[2:]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the operations' intervals, merged, in order."""
        out: List[List[int]] = []
        for _, s, e in self.ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            by[name[:120]] += (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: Spans, window: Tuple[int, int],
                  n: int = 10) -> List[list]:
        """Idle seconds inside ``window`` (host ns), summed by what the
        host was doing at each gap's middle: the innermost of spans
        "prefill", "decode_step" and "sample", else "engine_loop" inside
        a "generate" span (the engine's own Python and its ``tolist``),
        else "harness"."""
        inner = sorted((s, e, lab) for lab, s, e, _ in spans.host
                       if lab in ("prefill", "decode_step", "sample"))
        outer = sorted((s, e) for lab, s, e, _ in spans.host
                       if lab == "generate")
        starts = [s for s, _, _ in inner]
        ostarts = [s for s, _ in outer]
        lo = window[0] + self.offset_ns
        hi = window[1] + self.offset_ns
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        by: Dict[str, float] = defaultdict(float)
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            g0, g1 = max(g0, lo), min(g1, hi)
            if g1 <= g0:
                continue
            mid = (g0 + g1) // 2 - self.offset_ns
            by[_label_at(mid, inner, starts, outer, ostarts)] += \
                (g1 - g0) / 1e9
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _label_at(t, inner, starts, outer, ostarts) -> str:
    i = bisect.bisect_right(starts, t) - 1
    # spans do not overlap across labels except by nesting, and the inner
    # ones never nest in one another here
    if i >= 0 and inner[i][1] >= t:
        return inner[i][2]
    j = bisect.bisect_right(ostarts, t) - 1
    if j >= 0 and outer[j][1] >= t:
        return "engine_loop"
    return "harness"
