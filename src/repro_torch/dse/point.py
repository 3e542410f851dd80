"""DesignPoint: one G-GPU design candidate, joining both evaluation layers
(the port's copy of ``repro.dse.point``).

A design point composes the two halves the repo used to evaluate in silos:

  * the **physical version** (``repro_torch.core.ppa.GGPUVersion``) — the
    planner's analytic map output: divided memory inventory, inserted
    pipeline stages, achieved fmax, area, power;
  * the **engine config** (``repro_torch.ggpu.engine.GGPUConfig``) — what
    the cycle-accurate simulator runs: CU count, cache organization, fused
    dispatch width, and the ``pipeline_depth`` feedback knob.

``design_point`` closes the loop: it runs GPUPlanner's map for the spec's
(CU count, frequency target) over a memory inventory rewritten for the
spec's cache organization, then builds the engine config *from the planned
version* — in particular ``pipeline_depth = version.pipelines``, so the
simulator charges the CPI cost of every stage the map inserted to close
timing. Wall-clock = cycles(depth) / fmax(depth) is then a real trade-off
instead of the analytic map's free-pipelining assumption.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

from repro_torch.core.planner import Plan, plan
from repro_torch.core.ppa import GGPUVersion, baseline_inventory
from repro_torch.core.sram import MIN_WORDS, Macro
from repro_torch.ggpu.engine import GGPUConfig


def memsys_inventory(memsys: str, n_cus: int,
                     inventory: Optional[List[Macro]] = None) -> List[Macro]:
    """Rewrite the baseline memory inventory for a cache organization, so
    the analytic map prices what the engine simulates:

      * ``shared``     — the paper's central multi-port cache (unchanged);
      * ``banked``     — the data cache + tag store replicate per CU at full
        size (aggregate capacity and area grow with CU count);
      * ``banked-iso`` — per-CU banks splitting the shared capacity
        (word count divided by CU count; the per-block periphery overhead
        makes this slightly larger than shared, exactly the paper's
        division trade-off).
    """
    inv = list(inventory if inventory is not None else baseline_inventory())
    if memsys == "shared":
        return inv
    if memsys not in ("banked", "banked-iso"):
        raise KeyError(f"no inventory rule for memsys {memsys!r}")
    out = []
    for m in inv:
        if m.name.startswith("dcache"):
            if memsys == "banked":
                m = replace(m, per_cu=True)
            else:
                m = replace(m, per_cu=True,
                            words=max(MIN_WORDS, m.words // n_cus))
        out.append(m)
    return out


@dataclass(frozen=True)
class DesignSpec:
    """The searchable knobs of one candidate design."""
    n_cus: int = 1
    freq_target_mhz: float = 500.0
    memsys: str = "shared"
    fuse: int = 4
    # None: take the planner's inserted stage count (the closed loop).
    # An explicit value overrides it — depth 0 reproduces the analytic
    # map's free-pipelining assumption as its own sweepable point.
    pipeline_depth: Optional[int] = None

    def label(self) -> str:
        d = "plan" if self.pipeline_depth is None else self.pipeline_depth
        return (f"{self.n_cus}cu@{self.freq_target_mhz:.0f}"
                f"/{self.memsys}/d{d}")


@dataclass
class DesignPoint:
    """A planned candidate: spec + the map's version + the engine config."""
    spec: DesignSpec
    plan: Plan
    config: GGPUConfig

    @property
    def version(self) -> GGPUVersion:
        return self.plan.version

    @property
    def freq_mhz(self) -> float:
        """Achieved frequency: the target when the map closed, the map's
        best achievable fmax otherwise (the paper's 8CU@667 -> 600)."""
        return self.config.freq_mhz

    @property
    def area_mm2(self) -> float:
        return self.version.total_area_mm2()

    @property
    def power_w(self) -> float:
        return self.version.total_w()

    def label(self) -> str:
        """Unique per sweep point: a derated design keeps its target in the
        label (``8cu@667~601``), since distinct targets can derate to the
        same achieved frequency; an explicitly overridden pipeline depth is
        marked ``!`` (a forced depth can coincide with the planned one);
        a non-default fuse width is appended."""
        freq = (f"{self.spec.freq_target_mhz:.0f}" if self.plan.achieved
                else f"{self.spec.freq_target_mhz:.0f}~{self.freq_mhz:.0f}")
        forced = "" if self.spec.pipeline_depth is None else "!"
        fuse = "" if self.spec.fuse == 4 else f"/f{self.spec.fuse}"
        return (f"{self.spec.n_cus}cu@{freq}/{self.spec.memsys}"
                f"/d{self.config.pipeline_depth}{forced}{fuse}")


def design_point(spec: DesignSpec, **cfg_kw) -> DesignPoint:
    """Plan one candidate end to end: memsys-aware inventory -> analytic
    map -> engine config carrying the map's pipeline depth. Extra keyword
    arguments become ``GGPUConfig`` fields (e.g. ``cache_lines=128``)."""
    inv = memsys_inventory(spec.memsys, spec.n_cus)
    p = plan(spec.n_cus, spec.freq_target_mhz, inventory=inv)
    if p.achieved:
        freq = spec.freq_target_mhz
    else:
        # the paper keeps the layout at its best achievable frequency
        freq = round(p.version.fmax_mhz(), 0)
    p.version.freq_mhz = freq
    depth = (p.version.pipelines if spec.pipeline_depth is None
             else spec.pipeline_depth)
    cfg = GGPUConfig(n_cus=spec.n_cus, memsys=spec.memsys, fuse=spec.fuse,
                     pipeline_depth=depth, freq_mhz=freq, **cfg_kw)
    return DesignPoint(spec=spec, plan=p, config=cfg)
