"""Autotuning compiler back-end: schedule search over lowering choices
(the port's copy of ``repro.compiler.autotune``; every candidate is
simulated through the port's ``dse.Evaluator`` on ``device``, the card
unless the caller names another).

The compiler's lowering knobs — ``coarsen`` tiling, loop-invariant
hoisting, the branchy ``Guard`` idiom vs branch-free select, and const
address peeling — are a per-kernel *schedule* (``lower.Schedule``). This
module searches a declared ``ScheduleSpace`` exhaustively: every
candidate is re-traced and lowered through the parameterized hooks
(``compile_kernel(..., schedule=...)``), **verified bit-exact against
the default kernel's IR oracle**, and costed in true cycles through
``dse.Evaluator``'s workload path.

Costing is content-addressed three ways, which is what makes sweeps and
re-runs near-free:

  * the candidate *program bytes* are a pure function of (IR, schedule),
    so the executor-level memo key ``(name, items, sha1(prog),
    sha1(mem))`` **is** an (IR, schedule, input) key;
  * the engine *configuration* enters through the shared per-config
    executor registry (``serve.executors.get_executor``), with
    ``freq_mhz`` normalized out (``sim_key``);
  * all cache-missing candidates of one ``autotune`` call are costed in
    a **single pipelined Scheduler drain** (``Evaluator.simulate``), so
    a whole schedule space costs one or two batched dispatches.

Two surfaces:

  * ``autotune(fn, shapes, cfg)`` — best ``CompiledKernel`` for one
    kernel on one engine config, plus a per-candidate report. The
    default schedule is always in the candidate set, so the tuned
    kernel is *never worse than the default by construction*; the
    choice is deterministic (min over ``(cycles, prog_len,
    schedule.sort_key())``).
  * ``codesign(defs, ...)`` — the co-design loop: one ``dse.search``
    per candidate schedule over a shared workload suite, ranked jointly
    by ``dse.joint_frontier`` so the Pareto frontier is over
    ``(DesignPoint, Schedule)`` pairs — a schedule that makes a small
    design fast enough evicts a bigger design from the frontier.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.compiler.frontend import compile_kernel
from repro_torch.compiler.ir import CompileError
from repro_torch.compiler.lower import (DEFAULT_SCHEDULE, CompiledKernel,
                                        Schedule)
from repro_torch.compiler.suite import def_args, hand_benches, kernel_def
from repro_torch.dse.evaluate import Evaluator
from repro_torch.dse.search import cycle_objective, joint_frontier, search
from repro_torch.ggpu.programs import Bench


# ---------------------------------------------------------------------------
# the schedule space
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScheduleSpace:
    """The declared per-kernel search space: the cross product of the
    lowering knobs, filtered to schedules valid for the kernel at hand
    (``coarsen`` must divide the output length)."""
    coarsen: Tuple[int, ...] = (1, 2, 4)
    hoist: Tuple[bool, ...] = (True, False)
    branchy: Tuple[bool, ...] = (True, False)
    peel: Tuple[bool, ...] = (True, False)

    def candidates(self, out_len: int) -> List[Schedule]:
        """Valid schedules for a kernel with ``out_len`` outputs, in
        deterministic (default-first) order. The default schedule is
        always included so a tuned kernel can never lose to it."""
        seen = {DEFAULT_SCHEDULE}
        for c in self.coarsen:
            if c < 1 or out_len % c:
                continue
            for h in self.hoist:
                for b in self.branchy:
                    for p in self.peel:
                        seen.add(Schedule(coarsen=c, hoist=h,
                                          branchy=b, peel=p))
        return sorted(seen, key=Schedule.sort_key)

    def size(self) -> int:
        return (len(set(self.coarsen)) * len(set(self.hoist))
                * len(set(self.branchy)) * len(set(self.peel)))


#: full space swept by the nightly compiler job
DEFAULT_SPACE = ScheduleSpace()

#: trimmed space for the PR-blocking smoke path: the coarsening axis plus
#: the branch idiom (the two knobs that move cycles the most), hoist/peel
#: pinned to their defaults
SMOKE_SPACE = ScheduleSpace(coarsen=(1, 2), hoist=(True,),
                            branchy=(True, False), peel=(True,))


# ---------------------------------------------------------------------------
# single-kernel autotuning
# ---------------------------------------------------------------------------

@dataclass
class CandidateReport:
    """One lowered candidate: its schedule, cost, and verification."""
    schedule: Schedule
    cycles: int
    time_us: float
    prog_len: int                # SIMT program length (static code size)
    verified: bool               # bit-exact vs the default kernel's oracle
    best: bool = False

    def report(self) -> dict:
        return {
            "schedule": self.schedule.label(),
            "cycles": int(self.cycles),
            "time_us": round(self.time_us, 3),
            "prog_len": int(self.prog_len),
            "verified": bool(self.verified),
            "best": bool(self.best),
        }


@dataclass
class AutotuneResult:
    """Outcome of one schedule search: the chosen kernel + the sweep."""
    name: str
    best: CompiledKernel
    candidates: List[CandidateReport]
    default_cycles: int
    best_cycles: int
    cache_hits: int = 0
    objective: object = field(repr=False, default=None)

    @property
    def best_schedule(self) -> Schedule:
        return self.best.schedule

    @property
    def speedup(self) -> float:
        """Default-lowering cycles over tuned cycles (>= 1.0 always:
        the default schedule is in the candidate set)."""
        return self.default_cycles / max(self.best_cycles, 1)

    def report(self) -> dict:
        return {
            "name": self.name,
            "best_schedule": self.best_schedule.label(),
            "default_cycles": int(self.default_cycles),
            "tuned_cycles": int(self.best_cycles),
            "tuned_vs_default": round(self.best_cycles
                                      / max(self.default_cycles, 1), 4),
            "n_candidates": len(self.candidates),
            "candidates": [c.report() for c in self.candidates],
        }


def _oracle_bench(k: CompiledKernel, mem0: np.ndarray,
                  expect: np.ndarray, label: str):
    """A ``programs.Bench`` record for one candidate whose reference is
    the *default* kernel's oracle output — so ``Evaluator(check=True)``
    enforces candidate-vs-original-IR bit-exactness while costing."""
    def ref(_mem, _n, _expect=expect):
        return _expect

    return Bench(label, k.prog, mem0, k.n_items, k.out,
                 k.scalar_prog, mem0.copy(), k.out, ref,
                 k.n_items, k.n_items)


def autotune(fn: Callable, shapes, cfg, *,
             space: ScheduleSpace = DEFAULT_SPACE,
             name: Optional[str] = None,
             inputs=None, seed: int = 0, device=None) -> AutotuneResult:
    """Search ``space`` for the fastest schedule of ``fn`` on engine
    config ``cfg``.

    ``fn``/``shapes`` as in ``compile_kernel``; every candidate is traced
    fresh (coarsening changes the kernel IR), lowered, run through one
    batched ``dse.Evaluator`` drain with ``check=True`` against the
    default kernel's oracle, and ranked by true cycles. Deterministic:
    same (fn, shapes, space, cfg) -> same chosen schedule. The drain runs
    on ``device`` (``None``: the card; ``"cpu"``: the plain path)."""
    base = compile_kernel(fn, shapes, name=name)
    name = base.name
    if inputs is None:
        inputs = base.random_inputs(seed=seed)
    mem0 = base.build_mem(inputs)
    expect = base.reference(inputs)

    kernels: Dict[str, CompiledKernel] = {}
    workloads: Dict[str, object] = {}
    for sched in space.candidates(base.kernel.out_len):
        k = base if sched == DEFAULT_SCHEDULE \
            else compile_kernel(fn, shapes, name=name, schedule=sched)
        label = f"{name}@{sched.label()}"
        kernels[label] = k
        workloads[label] = _oracle_bench(k, mem0, expect, label)

    ev = Evaluator(benches=(), workloads=workloads, check=True,
                   device=device)
    before = ev.cache_size()
    ev.simulate(cfg)                 # one drain for every cache miss
    rows: List[CandidateReport] = []
    for label, k in kernels.items():
        info, _ = ev.cycles(cfg, label)
        rows.append(CandidateReport(
            schedule=k.schedule, cycles=int(info["cycles"]),
            time_us=info["cycles"] / cfg.freq_mhz,
            prog_len=int(k.prog.shape[0]), verified=True))

    best_row = min(rows, key=lambda r: (r.cycles, r.prog_len,
                                        r.schedule.sort_key()))
    best_row.best = True
    default_cycles = next(r.cycles for r in rows
                          if r.schedule == DEFAULT_SCHEDULE)
    best = kernels[f"{name}@{best_row.schedule.label()}"]
    return AutotuneResult(
        name=name, best=best, candidates=rows,
        default_cycles=default_cycles, best_cycles=best_row.cycles,
        cache_hits=before)


def autotune_suite(names: Sequence[str], cfg, *,
                   sizes: Optional[Dict[str, Tuple[int, ...]]] = None,
                   space: ScheduleSpace = DEFAULT_SPACE,
                   seed: int = 0,
                   device=None) -> Dict[str, AutotuneResult]:
    """Autotune suite benches by name (sizes as in ``suite.
    hand_benches``), against the hand-written benches' memory images."""
    out: Dict[str, AutotuneResult] = {}
    hands = hand_benches(sizes)
    for n in names:
        fn, shapes = kernel_def(n, *def_args(n, hands[n]))
        out[n] = autotune(fn, shapes, cfg, space=space, name=n, seed=seed,
                          device=device)
    return out


# ---------------------------------------------------------------------------
# co-design: (DesignPoint, Schedule) pairs on one frontier
# ---------------------------------------------------------------------------

@dataclass
class CodesignResult:
    """Per-schedule DSE results plus the joint co-designed frontier."""
    results: Dict[str, "object"]          # schedule label -> SearchResult
    joint: "object"                       # dse.JointResult

    @property
    def frontier(self):
        return self.joint.frontier

    def report(self) -> List[dict]:
        return self.joint.report()


def codesign(defs: Dict[str, Tuple[Callable, Dict[str, object]]],
             specs=None, *,
             space: ScheduleSpace = DEFAULT_SPACE,
             objective=None, seed: int = 0, device=None,
             **grid_kw) -> CodesignResult:
    """Close the HW/SW loop: rank ``(DesignPoint, Schedule)`` pairs.

    ``defs`` maps workload names to ``(fn, shapes)`` definitions (e.g.
    from ``suite.kernel_def``). For every schedule valid across **all**
    workloads, the suite is recompiled, verified against the default
    oracle, and swept through ``dse.search`` (specs or ``grid_kw`` as in
    ``enumerate_specs``); the per-schedule results are then ranked as
    one population by ``dse.joint_frontier``, so the returned frontier
    is over co-designed configurations. Every simulation runs on
    ``device`` (``None``: the card)."""
    if objective is None:
        objective = cycle_objective
    if not defs:
        raise CompileError("codesign needs at least one workload")

    bases = {n: compile_kernel(fn, shapes, name=n)
             for n, (fn, shapes) in defs.items()}
    joint_len = math.gcd(*[b.kernel.out_len for b in bases.values()])
    prepared = {}
    for n, b in bases.items():
        inputs = b.random_inputs(seed=seed)
        prepared[n] = (b.build_mem(inputs), b.reference(inputs))

    results = {}
    for sched in space.candidates(joint_len):
        workloads = {}
        for n, (fn, shapes) in defs.items():
            k = bases[n] if sched == DEFAULT_SCHEDULE \
                else compile_kernel(fn, shapes, name=n, schedule=sched)
            mem0, expect = prepared[n]
            workloads[n] = _oracle_bench(k, mem0, expect, n)
        ev = Evaluator(benches=(), workloads=workloads, check=True,
                       device=device)
        results[sched.label()] = search(specs, evaluator=ev,
                                        objective=objective, **grid_kw)
    return CodesignResult(results=results,
                          joint=joint_frontier(results, objective))
