"""Deterministic fault injection for the G-GPU serving stack (PyTorch port
of ``repro.faults``).

Three layers:

  * :mod:`repro_torch.faults.plan` — ``FaultPlan``: a seed-keyed, stateless
    chaos description whose every decision is a pure hash of
    ``(seed, kind, ticket, attempt)`` — reproducible anywhere and
    independent of chunk grouping or retry interleaving.
  * :mod:`repro_torch.faults.inject` — ``FaultInjector``: the transparent
    executor wrapper that applies a plan at the dispatch boundary
    (SEU bit flips via the engine's fused XOR patch path, straggler
    holds, wedged devices surfacing as ``DeviceTimeout``).
  * :mod:`repro_torch.faults.scenarios` — the ``FAULTS`` registry axis
    built-ins (``none``/``seu``/``straggler``/``device-loss``): named
    ``FaultScenario`` bundles of a plan plus the serve-side resilience
    knobs that answer it, pluggable into CI sweeps and chaos benches.

Injection is strictly opt-in: nothing in this package touches the
serving path unless an injector is interposed, and an inactive plan
injects nothing — results stay byte-identical.
"""
from repro_torch.faults.inject import FaultInjector
from repro_torch.faults.plan import FaultPlan
from repro_torch.faults.scenarios import (FaultScenario, device_loss, no_faults,
                                    seu, straggler)

__all__ = [
    "FaultInjector", "FaultPlan", "FaultScenario",
    "device_loss", "no_faults", "seu", "straggler",
]
