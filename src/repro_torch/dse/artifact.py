"""Standardized machine-readable DSE artifact (``BENCH_dse.json``); the
port's copy of ``repro.dse.artifact``.

The JAX package's schema, field for field, so the port's artifact is
compared with the committed baseline by the same exact fields (cycles,
frontier membership):

    {
      "schema": "ggpu-dse/1",
      "reference": "<label of the design point the bench map describes>",
      "benches": { "<bench>": { "cycles": int,
                                "sim_wall_s": float,
                                "fmax_mhz": float,
                                "area_mm2": float,
                                "perf_per_area": float,
                                "time_us": float } },
      "points": [ per-point report rows ... ],     # present for sweeps
      "frontier": [ labels ... ],
      "analytic_frontier": [ labels ... ],
      "excluded_analytic": [ labels ... ]
    }
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

from repro_torch.dse.evaluate import EvaluatedPoint

SCHEMA = "ggpu-dse/1"


def bench_map(point: EvaluatedPoint) -> dict:
    """The satellite schema: bench -> {cycles, sim wall-clock, fmax, area,
    perf/area} for one evaluated design point."""
    out = {}
    for name, m in point.per_bench.items():
        t = m.time_us
        out[name] = {
            "cycles": int(m.cycles),
            "sim_wall_s": float(m.sim_wall_s),
            "fmax_mhz": float(point.point.freq_mhz),
            "area_mm2": float(point.area_mm2),
            "perf_per_area": (1.0 / t) / point.area_mm2,
            "time_us": float(t),
        }
    return out


def dse_artifact(reference: EvaluatedPoint,
                 result: Optional["SearchResult"] = None) -> dict:
    """Build the artifact dict: the reference point's bench map, plus the
    full sweep/frontier when a ``SearchResult`` is given."""
    art = {
        "schema": SCHEMA,
        "reference": reference.label(),
        "benches": bench_map(reference),
    }
    if result is not None:
        art["points"] = result.report()
        art["frontier"] = [p.label() for p in result.frontier]
        art["analytic_frontier"] = [p.label()
                                    for p in result.analytic_frontier]
        art["excluded_analytic"] = [p.label()
                                    for p in result.excluded_analytic]
    return art


def write_artifact(path: Union[str, Path], reference: EvaluatedPoint,
                   result: Optional["SearchResult"] = None) -> Path:
    path = Path(path)
    path.write_text(json.dumps(dse_artifact(reference, result), indent=2,
                               sort_keys=True) + "\n")
    return path
