"""Spans and counters of the port's serving path, kept in memory for the
caller to read.

``Tracer(device)`` records each ``span(label, device=False)`` as a host
interval on ``time.perf_counter_ns`` with its parent, the label of the
innermost span open when it starts: ``host`` holds (label, t0_ns, t1_ns,
parent) in the order the spans close. With ``device=True`` on a card a
span also records a CUDA event pair on the current stream; ``settle()``
reads each pair into ``device_ms[label]`` as (ms, parent). Off a card the
host interval stands in. ``count(name, value)`` adds an int, or a 0-dim
tensor that ``settle()`` sums, to ``counters[name]``. Nothing here waits
for the card and no counter launches a kernel: call ``settle()`` after
the caller's own sync (``generate`` has returned its tokens, or
``torch.cuda.synchronize()``), then read ``host``, ``device_ms`` and
``counters``.

``OFF`` records nothing: its ``span`` returns one shared
``nullcontext()``, its ``count`` returns at once and ``OFF.on`` is
False. ``active(tracer)`` makes ``tracer`` what ``current()`` returns
inside the block, in the running thread, so that code below the engine
(the MoE FFN) reaches the tracer of the ``generate`` it runs under
without an argument.

What the serving path records (``Engine(..., tracer=Tracer(device))``):

- ``serve/llm.py`` ``Engine.generate``: spans ``prefill`` (device, the
  model's prefill of a wave), ``decode_step`` (device, around
  ``decode_fn``, which launches a step and does not wait for it),
  ``sample`` (host) and ``sync`` (host, around each ``tolist`` of the
  sampled tokens, the one place the host waits for the card); counters
  ``prefill_tokens`` (a wave's prompt tokens), ``prefill_pad_tokens``
  (its left pads) and ``decode_steps``.
- ``models/moe.py``: span ``moe`` (device, each layer's ``apply_moe``);
  counters ``moe_pairs`` (the layer's B*S*K (token, choice) pairs) and
  ``moe_dropped_pairs`` (those past their expert's capacity).
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

_NULL = contextlib.nullcontext()


class Tracer:
    on = True

    def __init__(self, device):
        self.on_card = torch.device(device).type == "cuda"
        self.host: List[Tuple[str, int, int, Optional[str]]] = []
        self.device_ms: Dict[str, List[Tuple[float, Optional[str]]]] = \
            defaultdict(list)
        self.counters: Dict[str, int] = defaultdict(int)
        self._events: list = []
        self._pending: Dict[str, list] = defaultdict(list)
        self._open: List[str] = []

    def span(self, label: str, device: bool = False):
        return _Span(self, label, device)

    def count(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            self._pending[name].append(value)
        else:
            self.counters[name] += int(value)

    def settle(self) -> None:
        """Read the device spans and tensor counts recorded so far; call
        it after a sync."""
        for label, a, b, parent in self._events:
            self.device_ms[label].append((a.elapsed_time(b), parent))
        self._events.clear()
        for name, values in self._pending.items():
            self.counters[name] += int(torch.stack(values).sum())
        self._pending.clear()

    def ms(self, label: str, parent: Optional[str] = "*") -> List[float]:
        """Device ms of every ``label`` span (whose parent is ``parent``
        unless that is "*")."""
        return [ms for ms, p in self.device_ms.get(label, [])
                if parent == "*" or p == parent]


class _Span:
    __slots__ = ("tr", "label", "device", "parent", "events", "t0")

    def __init__(self, tr: Tracer, label: str, device: bool):
        self.tr, self.label, self.device = tr, label, device

    def __enter__(self):
        tr = self.tr
        self.parent = tr._open[-1] if tr._open else None
        self.events = None
        if self.device and tr.on_card:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        tr._open.append(self.label)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self.tr
        tr._open.pop()
        tr.host.append((self.label, self.t0, t1, self.parent))
        if self.events is not None:
            self.events[1].record()
            tr._events.append((self.label, *self.events, self.parent))
        elif self.device:
            tr.device_ms[self.label].append(((t1 - self.t0) / 1e6,
                                             self.parent))
        return False


class _Off(Tracer):
    on = False

    def __init__(self):
        super().__init__("cpu")

    def span(self, label: str, device: bool = False):
        return _NULL

    def count(self, name: str, value) -> None:
        return None


OFF: Tracer = _Off()
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("tracer",
                                                         default=OFF)


def current() -> Tracer:
    return _CURRENT.get()


@contextlib.contextmanager
def active(tracer: Tracer):
    """``current()`` is ``tracer`` inside the block (in this thread)."""
    token = _CURRENT.set(tracer)
    try:
        yield tracer
    finally:
        _CURRENT.reset(token)
