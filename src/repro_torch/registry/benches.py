"""Bench axis built-ins: the eight suite benches as registry plugins (the
port's ``repro.registry.benches``).

A :class:`BenchSpec` is the plugin contract of the ``BENCHES`` axis:

  * ``build(*sizes)`` constructs the ``programs.Bench`` record (ISA
    programs, memory images, numpy reference); no arguments means the
    paper's Table III sizes.
  * ``kernel_def`` is the reference's traceable tensor-DSL definition
    that the compiler and autotuner re-lower. The port has no compiler
    yet (ROADMAP.md, queue item 7), so it is ``None`` on every built-in
    until that slice lands.
  * ``smoke_sizes`` are the (scalar, gpu) build arguments of the registry
    smoke's one minimal launch per bench (``programs.SMOKE_SIZES``).
  * ``paper`` marks the seven benches the paper's tables report.

``ordered_names()`` keeps the legacy table order (paper order, then
extensions, then any plugin benches sorted), while the axis itself
enumerates sorted like every other axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from repro_torch.ggpu import programs
from repro_torch.ggpu.programs import LEGACY_ORDER
from repro_torch.registry import BENCHES

__all__ = ["BenchSpec", "LEGACY_ORDER", "ordered_names"]


@dataclass(frozen=True)
class BenchSpec:
    """One registered workload (see module doc)."""
    name: str
    build: Callable          # (*sizes) -> programs.Bench
    kernel_def: Optional[Callable] = None  # the compiler slice fills it
    smoke_sizes: Tuple[int, ...] = ()
    paper: bool = False

    def describe(self) -> dict:
        return {
            "paper": self.paper,
            "has_kernel_def": self.kernel_def is not None,
            "smoke_sizes": list(self.smoke_sizes),
        }


for _name in LEGACY_ORDER:
    BENCHES.register(_name, BenchSpec(
        name=_name,
        build=getattr(programs, f"_{_name}"),
        smoke_sizes=programs.SMOKE_SIZES[_name],
        paper=_name in programs.PAPER_CYCLES))


def ordered_names() -> list:
    """Bench names in legacy table order, plugin extras (sorted) last."""
    names = BENCHES.names()
    legacy = [n for n in LEGACY_ORDER if n in names]
    return legacy + [n for n in names if n not in LEGACY_ORDER]
