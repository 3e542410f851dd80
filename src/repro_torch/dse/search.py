"""Pareto-frontier search over the joint G-GPU design space (PyTorch
port of ``repro.dse.search``).

The search enumerates ``DesignSpec`` candidates over {CU count, frequency
target, cache organization, fused-dispatch width, pipeline depth}, plans
each one analytically (``dse.point.design_point``), evaluates all of them
cycle-accurately through one shared ``Evaluator`` (config-grouped, batched,
cached), and returns the Pareto frontier under minimize-(wall-clock, area)
— the paper's Fig. 5 (raw performance) and Fig. 6 (performance derated by
area) axes joined into one dominance relation.

Every point is also ranked under the **free-pipelining assumption** the
analytic map makes (depth-0 cycles at the planned frequency). The points
on that analytic frontier that the cycle-accurate evaluation dominates are
reported in ``SearchResult.excluded_analytic`` — the designs a
spreadsheet-only flow would have picked and the simulator rejects.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.dse.evaluate import EvaluatedPoint, Evaluator
from repro_torch.dse.point import DesignSpec, design_point
from repro_torch.ggpu.engine import MEMSYS, GGPUConfig

Objective = Callable[[EvaluatedPoint], Tuple[float, ...]]


def cycle_objective(p: EvaluatedPoint) -> Tuple[float, float]:
    """Minimize (cycle-accurate wall-clock, area)."""
    return (p.time_us, p.area_mm2)


def analytic_objective(p: EvaluatedPoint) -> Tuple[float, float]:
    """Minimize (free-pipelining wall-clock, area) — what the map sees."""
    return (p.analytic_time_us, p.area_mm2)


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Pareto dominance for minimization: a is no worse everywhere and
    strictly better somewhere."""
    if len(a) != len(b):
        raise ValueError("objective vectors must have equal length")
    return all(x <= y for x, y in zip(a, b)) \
        and any(x < y for x, y in zip(a, b))


def pareto_frontier(items: Sequence, key: Callable[[object], Sequence[float]]
                    ) -> List:
    """Non-dominated subset of ``items`` under minimization of ``key``,
    in stable input order (ties — equal vectors — are all kept)."""
    vecs = [tuple(key(it)) for it in items]
    return [it for it, v in zip(items, vecs)
            if not any(dominates(w, v) for w in vecs)]


@dataclass
class SearchResult:
    points: List[EvaluatedPoint]
    frontier: List[EvaluatedPoint]            # cycle-accurate Pareto set
    analytic_frontier: List[EvaluatedPoint]   # free-pipelining Pareto set
    excluded_analytic: List[EvaluatedPoint]   # analytic picks the cycle
    #                                           model dominates
    objective: Objective = field(repr=False, default=cycle_objective)

    def report(self) -> List[dict]:
        front = {id(p) for p in self.frontier}
        afront = {id(p) for p in self.analytic_frontier}
        rows = []
        for p in self.points:
            r = p.report()
            r["on_frontier"] = id(p) in front
            r["on_analytic_frontier"] = id(p) in afront
            rows.append(r)
        return rows


@dataclass
class JointPoint:
    """One co-designed candidate: a hardware design point evaluated under
    one compiler schedule variant (``variant`` is the schedule label)."""
    variant: str
    point: EvaluatedPoint

    def label(self) -> str:
        return f"{self.point.label()}|{self.variant}"

    def report(self) -> dict:
        r = self.point.report()
        r["schedule"] = self.variant
        return r


@dataclass
class JointResult:
    """The (DesignPoint, Schedule) product ranked under one dominance
    relation — the co-designed Pareto frontier."""
    points: List[JointPoint]
    frontier: List[JointPoint]
    objective: Objective = field(repr=False, default=cycle_objective)

    def report(self) -> List[dict]:
        front = {id(p) for p in self.frontier}
        rows = []
        for p in self.points:
            r = p.report()
            r["on_frontier"] = id(p) in front
            rows.append(r)
        return rows


def joint_frontier(variants: Dict[str, SearchResult],
                   objective: Objective = cycle_objective) -> JointResult:
    """Rank the union of several per-variant search results (e.g. one
    ``search`` per candidate compiler schedule) as a single population of
    ``(DesignPoint, variant)`` pairs. A hardware point survives only if no
    (point, schedule) pair dominates it — so a schedule that makes a
    smaller design fast enough can evict a bigger design entirely."""
    pts = [JointPoint(v, p)
           for v, res in variants.items() for p in res.points]
    frontier = pareto_frontier(pts, lambda jp: objective(jp.point))
    return JointResult(points=pts, frontier=frontier, objective=objective)


def enumerate_specs(cus: Sequence[int] = (1, 2, 4, 8),
                    freq_targets: Sequence[float] = (500.0, 590.0, 667.0,
                                                     750.0),
                    memsys: Sequence[str] = ("shared",),
                    fuse: Sequence[int] = (4,),
                    pipeline_depths: Sequence[Optional[int]] = (None,)
                    ) -> List[DesignSpec]:
    """The candidate grid. ``pipeline_depths=(None,)`` takes each plan's
    own inserted-stage count (the closed loop); explicit integers add
    override points (0 = the free-pipelining analytic assumption run as a
    real — optimistic — design)."""
    return [DesignSpec(n_cus=c, freq_target_mhz=f, memsys=ms, fuse=fu,
                       pipeline_depth=d)
            for c in cus for f in freq_targets for ms in memsys
            for fu in fuse for d in pipeline_depths]


def search(specs: Optional[Sequence[DesignSpec]] = None,
           evaluator: Optional[Evaluator] = None,
           objective: Objective = cycle_objective,
           analytic: Objective = analytic_objective,
           device=None, **grid_kw) -> SearchResult:
    """Plan + evaluate + rank the design space.

    ``specs`` overrides the grid; otherwise ``grid_kw`` is forwarded to
    ``enumerate_specs``. ``evaluator`` defaults to a reduced-size xcorr
    evaluator (the paper's cache-pressure kernel) on ``device`` (``None``:
    the card) so a full sweep stays interactive; pass a configured
    ``Evaluator`` for the Table III suite (its device is the search's).
    """
    if specs is None:
        specs = enumerate_specs(**grid_kw)
    elif grid_kw:
        raise ValueError("pass either specs or grid keywords, not both")
    if evaluator is None:
        evaluator = Evaluator(benches=("xcorr",), sizes={"xcorr": (32, 256)},
                              device=device)
    elif device is not None:
        raise ValueError("pass device only without an evaluator (the "
                         "evaluator's device is the search's)")
    points = [design_point(s) for s in specs]
    evaluated = evaluator.evaluate(points)
    frontier = pareto_frontier(evaluated, objective)
    analytic_frontier = pareto_frontier(evaluated, analytic)
    front_ids = {id(p) for p in frontier}
    excluded = [p for p in analytic_frontier if id(p) not in front_ids]
    return SearchResult(points=evaluated, frontier=frontier,
                        analytic_frontier=analytic_frontier,
                        excluded_analytic=excluded, objective=objective)


def sweep_memsys(bench: str = "xcorr",
                 n_cus: Sequence[int] = (1, 8),
                 memsys: Optional[Sequence[str]] = None,
                 sizes: Optional[Tuple[int, int]] = (64, 1024),
                 device=None,
                 **cfg_kw) -> Dict[Tuple[int, str], dict]:
    """Cache-organization DSE: cycle-simulate ``bench`` on every
    (CU count, memory system) point; returns ``{(n_cus, memsys): info}``
    with the simulator's cycles/hits/misses per point.

    ``memsys`` defaults to every organization the engine has (sorted by
    name, as the reference's registry lists them). ``sizes`` are the bench
    constructor's (scalar, gpu) input sizes — the default is a reduced
    xcorr so a sweep stays interactive; pass ``None`` for the paper's
    Table III sizes. ``device``: where it runs (``None``: the card).
    Extra keyword arguments become ``GGPUConfig`` fields (e.g.
    ``cache_lines=128``)."""
    if memsys is None:
        memsys = tuple(sorted(MEMSYS))
    ev = Evaluator(benches=(bench,),
                   sizes=None if sizes is None else {bench: sizes},
                   device=device)
    out: Dict[Tuple[int, str], dict] = {}
    for c in n_cus:
        for ms in memsys:
            cfg = GGPUConfig(n_cus=c, memsys=ms, **cfg_kw)
            info, _ = ev.cycles(cfg, bench)
            out[(c, ms)] = info
    return out
