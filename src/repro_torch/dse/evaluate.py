"""Cycle-accurate evaluation of design points over the paper's benches
(PyTorch port of ``repro.dse.evaluate``).

Candidate design points are grouped by their *engine-visible*
configuration (the frozen ``GGPUConfig`` — frequency targets that plan to
the same pipeline depth share one simulation), and every uncached
(config, bench) pair is submitted to one ``serve.Scheduler`` drain per
config, whose chunk planner folds same-shape launches into cohorts and
batches. Cycle results are memoized on the process-wide shared executor
(``serve.executors.get_executor``) of the evaluator's device, keyed by
the bench content, so sweeps and repeat evaluators that touch the same
configuration share the cached cycles.

Each point is also evaluated under the **free-pipelining assumption**
(the same config at ``pipeline_depth=0``) — the cycles the analytic map
believes in. ``search.search`` uses the pair to show which analytic picks
the cycle-accurate model excludes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import _device
from repro_torch.dse.point import DesignPoint
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import GGPUConfig, KernelLaunchError
from repro_torch.serve.executors import _EXECUTORS, get_executor
from repro_torch.serve.scheduler import Scheduler

DEFAULT_BENCHES = ("xcorr",)
DEFAULT_SIZES: Dict[str, Tuple[int, int]] = {}   # empty: bench defaults


@dataclass
class BenchMetrics:
    """Per-bench outcome of one design point."""
    bench: str
    cycles: int                 # cycle-accurate (pipeline-depth-aware)
    analytic_cycles: int        # free-pipelining (depth-0) cycles
    time_us: float              # cycles / fmax
    analytic_time_us: float
    sim_wall_s: float           # simulator wall-clock share (amortized)
    info: dict = field(repr=False, default_factory=dict)


@dataclass
class EvaluatedPoint:
    """A design point with its end-to-end metrics.

    Aggregates are geometric means over the evaluated benches (the paper's
    Fig. 6 convention); energy = power x time."""
    point: DesignPoint
    per_bench: Dict[str, BenchMetrics]
    time_us: float
    analytic_time_us: float
    area_mm2: float
    power_w: float
    energy_uj: float
    perf_per_area: float        # (1 / time_us) / area_mm2
    sim_wall_s: float

    def label(self) -> str:
        return self.point.label()

    def report(self) -> dict:
        return {
            "label": self.label(),
            "n_cus": self.point.spec.n_cus,
            "freq_target_mhz": self.point.spec.freq_target_mhz,
            "fmax_mhz": self.point.freq_mhz,
            "memsys": self.point.spec.memsys,
            "fuse": self.point.config.fuse,
            "pipeline_depth": self.point.config.pipeline_depth,
            "achieved": self.point.plan.achieved,
            "time_us": round(self.time_us, 3),
            "analytic_time_us": round(self.analytic_time_us, 3),
            "area_mm2": round(self.area_mm2, 2),
            "power_w": round(self.power_w, 2),
            "energy_uj": round(self.energy_uj, 3),
            "perf_per_area": self.perf_per_area,
            "sim_wall_s": round(self.sim_wall_s, 4),
        }


def _geomean(vals: Sequence[float]) -> float:
    return float(math.exp(sum(math.log(max(v, 1e-12)) for v in vals)
                          / len(vals)))


class Evaluator:
    """Simulates benches for design points with config-level batching and a
    persistent cycle cache.

    ``benches`` are names from ``repro_torch.ggpu.programs`` (``_<name>``
    builders); ``sizes`` optionally maps a bench name to the builder's
    (scalar, gpu) input sizes — ``None``/missing uses the paper's Table
    III defaults. ``check=True`` downloads each final image and verifies
    it against the bench's numpy reference (a workload's against its own
    ``ref``). ``device`` is where the simulations run (``None``: the
    card).

    ``workloads`` maps extra names to pre-built ``Bench``-shaped records
    — e.g. compiled kernels from the tensor-expression DSL
    (``repro_torch.compiler.CompiledKernel.as_bench()`` or
    ``compiler.dsl_benches()``) — so the DSE sweeps generated workloads
    alongside (or instead of) the fixed list. A workload needs
    ``gpu_prog``/``gpu_mem``/``gpu_items``/``gpu_out``/``gpu_n``/``ref``;
    its name may also appear in ``benches`` to pin the evaluation order."""

    def __init__(self, benches: Sequence[str] = DEFAULT_BENCHES,
                 sizes: Optional[Dict[str, Tuple[int, int]]] = None,
                 check: bool = False,
                 workloads: Optional[Dict[str, object]] = None,
                 device=None):
        workloads = dict(workloads or {})
        self.bench_names = tuple(benches) + tuple(
            n for n in workloads if n not in benches)
        self.device = _device.resolve(device)
        sizes = dict(sizes or DEFAULT_SIZES)
        self._benches = {}
        self._keys: Dict[str, tuple] = {}
        for name in self.bench_names:
            if name in workloads:
                b = workloads[name]
            else:
                build = getattr(programs, f"_{name}")
                sz = sizes.get(name)
                b = build(*sz) if sz is not None else build()
            self._benches[name] = b
            # content-addressed memo key: safe to share across evaluators
            # with different bench sizes on the same executor
            self._keys[name] = (
                "bench", name, b.gpu_items,
                hashlib.sha1(b.gpu_prog.tobytes()).hexdigest(),
                hashlib.sha1(b.gpu_mem.tobytes()).hexdigest())
        self.check = check
        # (sim config, bench key) pairs THIS evaluator has verified; with
        # check=True a bench memoized by another (unchecked) evaluator is
        # re-simulated so the requested verification actually runs
        self._verified: set = set()

    # -- simulation ---------------------------------------------------------

    def _executor(self, cfg: GGPUConfig):
        return get_executor(cfg, device=self.device)

    def _simulate_config(self, cfg: GGPUConfig, names: Sequence[str]) -> None:
        """Run every unmemoized bench for one engine config as a single
        Scheduler drain (cohort/batch-folded where shapes allow) on the
        process-wide shared executor for that config. The evaluator needs
        cycles only, so each launch declares an empty ``out_region`` and
        the final memory images are never downloaded from the device —
        except under ``check=True``, which pulls the full image to verify
        it against the bench's numpy reference."""
        ex = self._executor(cfg)
        todo = [n for n in names
                if self._keys[n] not in ex.memo
                or (self.check
                    and (ex.cfg, self._keys[n]) not in self._verified)]
        if not todo:
            return
        sched = Scheduler(executor=ex)
        for n in todo:
            b = self._benches[n]
            sched.submit(b.gpu_prog, b.gpu_mem, b.gpu_items, tag=n,
                         out_region=None if self.check else (0, 0))
        t0 = time.perf_counter()
        results = sched.drain()
        wall = (time.perf_counter() - t0) / len(todo)
        if sched.quarantined:
            bad = "; ".join(f"{q.request.tag}: {q.error}"
                            for q in sched.quarantined.values())
            raise KernelLaunchError(
                f"bench simulation did not halt under {cfg}: {bad}")
        for mem, info in results:
            n = info["tag"]          # align by tag, not submission order
            if self.check:
                b = self._benches[n]
                np.testing.assert_array_equal(
                    mem[b.gpu_out], b.ref(b.gpu_mem, b.gpu_n))
                self._verified.add((ex.cfg, self._keys[n]))
            ex.memo[self._keys[n]] = (info, wall)

    def _lookup(self, cfg: GGPUConfig, bench: str) -> Tuple[dict, float]:
        return self._executor(cfg).memo[self._keys[bench]]

    def cache_size(self) -> int:
        """Memoized (config, bench) entries for this evaluator's bench set
        across the shared executors of its device."""
        keys = set(self._keys.values())
        return sum(1 for (_, dev), ex in _EXECUTORS.items()
                   if dev == self.device for k in ex.memo if k in keys)

    def simulate(self, cfg: GGPUConfig,
                 names: Optional[Sequence[str]] = None) -> None:
        """Ensure every named bench (default: all) is simulated/memoized
        under ``cfg`` — one Scheduler drain for all misses."""
        self._simulate_config(cfg, self.bench_names if names is None
                              else tuple(names))

    def cycles(self, cfg: GGPUConfig, bench: str) -> Tuple[dict, float]:
        self._simulate_config(cfg, [bench])
        info, wall = self._lookup(cfg, bench)
        # restate frequency-derived fields for the caller's actual config
        info = dict(info)
        info["time_us"] = info["cycles"] / cfg.freq_mhz
        return info, wall

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, points: Sequence[DesignPoint]
                 ) -> List[EvaluatedPoint]:
        """Evaluate candidates; simulation order is grouped by config so
        identical configs (and their depth-0 analytic twins) are simulated
        exactly once across the whole sweep."""
        # collect the needed (config, bench) work, preserving first-seen
        # config order for determinism
        wanted: Dict[GGPUConfig, None] = {}
        for p in points:
            wanted.setdefault(p.config)
            wanted.setdefault(dataclasses.replace(p.config, pipeline_depth=0))
        for cfg in wanted:
            self._simulate_config(cfg, self.bench_names)
        out = []
        for p in points:
            cfg0 = dataclasses.replace(p.config, pipeline_depth=0)
            per_bench: Dict[str, BenchMetrics] = {}
            for n in self.bench_names:
                info, wall = self._lookup(p.config, n)
                info0, _ = self._lookup(cfg0, n)
                cyc, cyc0 = info["cycles"], info0["cycles"]
                info = dict(info)
                info["time_us"] = cyc / p.freq_mhz
                per_bench[n] = BenchMetrics(
                    bench=n, cycles=cyc, analytic_cycles=cyc0,
                    time_us=cyc / p.freq_mhz,
                    analytic_time_us=cyc0 / p.freq_mhz,
                    sim_wall_s=wall, info=info)
            t = _geomean([m.time_us for m in per_bench.values()])
            t0 = _geomean([m.analytic_time_us for m in per_bench.values()])
            area = p.area_mm2
            power = p.power_w
            out.append(EvaluatedPoint(
                point=p, per_bench=per_bench, time_us=t,
                analytic_time_us=t0, area_mm2=area, power_w=power,
                energy_uj=power * t,
                perf_per_area=(1.0 / t) / area,
                sim_wall_s=sum(m.sim_wall_s for m in per_bench.values())))
        return out
