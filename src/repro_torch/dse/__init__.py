"""Unified design-space exploration over G-GPU design points (PyTorch port
of ``repro.dse``; the cycle simulations run on the card by default).

This package joins the two evaluation layers — GPUPlanner's analytic
fmax/PPA map (``repro_torch.core.planner`` / ``repro_torch.core.ppa``) and
the cycle-accurate execution engine (``repro_torch.ggpu.engine``) — into
one searchable space, the way the paper's generator flow intends (and
full-stack evaluators like Gemmini and AutoDNNchip practice):

  * ``point``    — ``DesignSpec`` / ``DesignPoint``: a candidate composes a
    planned ``GGPUVersion`` (fmax, area, power) with the ``GGPUConfig`` the
    engine simulates, including the pipeline-latency feedback knob
    (``pipeline_depth``) the analytic map cannot see.
  * ``evaluate`` — ``Evaluator``: end-to-end metrics (wall-clock =
    cycles/fmax, energy, perf/area) per bench, with config-grouped
    simulation (one ``serve.Scheduler`` drain per config) and a
    persistent cycle cache.
  * ``search``   — Pareto-frontier search over {n_cus, frequency target,
    memsys, fuse, pipeline depth}; reports the analytic-only picks the
    cycle-accurate evaluation excludes.
  * ``artifact`` — the standardized ``BENCH_dse.json`` emitter.
"""
from repro_torch.dse.artifact import bench_map, dse_artifact, write_artifact
from repro_torch.dse.evaluate import BenchMetrics, EvaluatedPoint, Evaluator
from repro_torch.dse.point import (DesignPoint, DesignSpec, design_point,
                             memsys_inventory)
from repro_torch.dse.search import (JointPoint, JointResult, SearchResult,
                              analytic_objective, cycle_objective, dominates,
                              enumerate_specs, joint_frontier,
                              pareto_frontier, search, sweep_memsys)

__all__ = [
    "DesignSpec", "DesignPoint", "design_point", "memsys_inventory",
    "BenchMetrics", "EvaluatedPoint", "Evaluator",
    "SearchResult", "search", "enumerate_specs", "sweep_memsys",
    "pareto_frontier", "dominates", "cycle_objective", "analytic_objective",
    "JointPoint", "JointResult", "joint_frontier",
    "bench_map", "dse_artifact", "write_artifact",
]
