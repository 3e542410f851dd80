"""GPUPlanner: the paper's automated spec -> versions flow (Fig. 2); the
port's copy of ``repro.core.planner``.

``plan(n_cus, freq_target)`` runs the iterative *map*: estimate the three
candidate critical paths (memory macro / logic / top-level interconnect),
then

  * critical path in a memory block  -> divide it (words first, word-size
    when the word count bottoms out) — the paper's memory-division strategy;
  * critical path in logic           -> insert a pipeline stage on demand;
  * critical path in the interconnect -> STOP: not fixable by division or
    pipelining (the paper's own 8CU@667 -> 600 MHz finding); report the
    best achievable frequency instead.

Each iteration is logged — the log *is* the paper's "dynamic spreadsheet"
map that tells a designer which memory to divide next before paying for
synthesis. ``enumerate_versions`` reproduces the 12-version Table I sweep.

This module is the *analytic* half of the DSE stack. The joint search —
composing these versions with the cycle-accurate engine (cache
organization, pipeline-latency feedback, Pareto ranking) — lives in
``repro_torch.dse``; ``sweep_memsys`` here is a thin deprecation shim over
``repro_torch.dse.sweep_memsys``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.ppa import GGPUVersion, baseline_inventory
from repro_torch.core.sram import MIN_WORDS, Macro, divided_path_delay

MAX_PIPELINES = 4
MAX_DIVISIONS_PER_MACRO = 6


@dataclass
class MapEntry:
    iteration: int
    fmax_mhz: float
    bottleneck: str            # memory:<name> | logic | interconnect
    action: str
    paths: Dict[str, float]


@dataclass
class Plan:
    version: GGPUVersion
    achieved: bool
    map_log: List[MapEntry] = field(default_factory=list)
    reason: str = ""


def _divide_macro(m: Macro) -> Optional[Macro]:
    if m.divided >= MAX_DIVISIONS_PER_MACRO:
        return None
    if m.words // 2 >= MIN_WORDS:
        return m.divide_words()
    if m.bits > 2:
        return m.divide_bits()
    return None


def plan(n_cus: int, freq_target_mhz: float,
         inventory: Optional[List[Macro]] = None) -> Plan:
    """Iterate the map until the target closes or the bottleneck is
    un-fixable. Deterministic and cheap — this is the 'first-order PPA
    estimation' stage of the paper's flow; synthesis (for us: the cycle
    simulator + benchmarks) validates the result."""
    v = GGPUVersion(n_cus, freq_target_mhz,
                    list(inventory or baseline_inventory()))
    target_ns = 1000.0 / freq_target_mhz
    log: List[MapEntry] = []
    it = 0
    while max(v.paths().values()) > target_ns:
        it += 1
        paths = v.paths()
        worst = max(paths, key=paths.get)
        if worst == "memory":
            mi = max(range(len(v.inventory)),
                     key=lambda i: divided_path_delay(v.inventory[i]))
            m = v.inventory[mi]
            m2 = _divide_macro(m)
            if m2 is None:
                log.append(MapEntry(it, v.fmax_mhz(), f"memory:{m.name}",
                                    "STOP: macro cannot divide further", paths))
                return Plan(v, False, log,
                            f"memory {m.name} at division limit")
            v.inventory[mi] = m2
            act = (f"divide {m.name}: {m.words}x{m.bits} -> "
                   f"2x {m2.words}x{m2.bits} (blocks {m.count}->{m2.count})")
            log.append(MapEntry(it, v.fmax_mhz(), f"memory:{m.name}", act,
                                paths))
        elif worst == "logic":
            if v.pipelines >= MAX_PIPELINES:
                log.append(MapEntry(it, v.fmax_mhz(), "logic",
                                    "STOP: pipeline limit", paths))
                return Plan(v, False, log, "logic pipeline limit reached")
            v.pipelines += 1
            log.append(MapEntry(it, v.fmax_mhz(), "logic",
                                f"insert pipeline stage #{v.pipelines}", paths))
        else:  # interconnect
            log.append(MapEntry(
                it, v.fmax_mhz(), "interconnect",
                "STOP: top-level wires dominate; pipelining ineffective "
                "(paper Sec. IV) — reduce CUs or accept lower frequency",
                paths))
            return Plan(v, False, log,
                        f"interconnect-bound at {v.fmax_mhz():.0f} MHz "
                        f"with {n_cus} CUs")
        if it > 64:
            return Plan(v, False, log, "did not converge")
    log.append(MapEntry(it + 1, v.fmax_mhz(), "-", "target met", v.paths()))
    return Plan(v, True, log)


def enumerate_versions(cus=(1, 2, 4, 8), freqs=(500.0, 590.0, 667.0)
                       ) -> List[Plan]:
    """The paper's 12-version sweep (Table I). Versions that miss their
    target report the best achievable frequency (8CU@667 -> ~600 MHz)."""
    out = []
    for f in freqs:
        for c in cus:
            p = plan(c, f)
            if not p.achieved:
                # the paper keeps the layout at its achievable frequency
                p.version.freq_mhz = round(p.version.fmax_mhz(), 0)
            out.append(p)
    return out


def sweep_memsys(bench: str = "xcorr",
                 n_cus: Sequence[int] = (1, 8),
                 memsys: Optional[Sequence[str]] = None,
                 sizes: Optional[Tuple[int, int]] = (64, 1024),
                 device=None,
                 **cfg_kw) -> Dict[Tuple[int, str], dict]:
    """Deprecated shim: the cache-organization sweep moved into the unified
    DSE subsystem. Import ``sweep_memsys`` from ``repro_torch.dse`` instead
    (same signature and return shape; ``device``: the card by default)."""
    import warnings

    from repro_torch.dse.search import sweep_memsys as _sweep
    warnings.warn(
        "repro_torch.core.planner.sweep_memsys is deprecated; use "
        "repro_torch.dse.sweep_memsys (the unified DSE subsystem)",
        DeprecationWarning, stacklevel=2)
    return _sweep(bench=bench, n_cus=n_cus, memsys=memsys, sizes=sizes,
                  device=device, **cfg_kw)


def speedup_table(ggpu_cycles: Dict[str, Dict[int, int]],
                  scalar_cycles: Dict[str, int],
                  input_ratio: Dict[str, float],
                  ggpu_freq_mhz: float = 667.0,
                  scalar_freq_mhz: float = 667.0):
    """Fig. 5's metric: speedup = scalar_cycles * input_ratio / ggpu_cycles
    (the paper's pessimistic-for-G-GPU linear input scaling), in cycles —
    and wall-clock speedup when frequencies differ."""
    rows = {}
    for k, per_cu in ggpu_cycles.items():
        rows[k] = {
            ncu: scalar_cycles[k] * input_ratio[k] / cyc
            for ncu, cyc in per_cu.items()
        }
    return rows
