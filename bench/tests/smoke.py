"""A checkout of the benchmark at a CPU test's size: ``make_root(tmp)``
lays out ``BENCHMARK.json`` with two small cells (the equations of both
configurations, at the ``tests/data`` sizes, under the ``tiny`` mix),
a copy of ``bench/`` and the program's ``src/`` beside them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"

# the widest gap that sound runs of the smoke cells read on this size,
# with room (test_bench_check.py reads both sides)
SMOKE_LIMIT = 0.5
SMOKE_REQUESTS = 4      # requests a smoke run compares (a wave of tiny)

CELLS = ("granite-smoke.tiny", "mixtral-smoke.tiny")


def spec() -> dict:
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    configs = [{"name": n, "source": "bench/tests/data", "file":
                f"bench/configs/{n}.json", "reduced": [], "why": "CPU test"}
               for n in ("granite-smoke", "mixtral-smoke")]
    workloads = [{"name": c, "config": c.split(".")[0], "traffic": "tiny",
                  "chips": 1, "why": "CPU test"} for c in CELLS]

    def cells_of(metric):
        # a metric that lists real cells lists the small cell of the same
        # model family ("granite", "mixtral") instead
        m = dict(metric)
        if "workloads" in m:
            m["workloads"] = [c for c in CELLS
                              if any(c.split(".")[0].split("-")[0]
                                     == w.split(".")[0].split("-")[0]
                                     for w in metric["workloads"])]
        return m
    return {**real, "configs": configs, "workloads": workloads,
            "end_to_end": [cells_of(m) for m in real["end_to_end"]],
            "per_layer": [cells_of(m) for m in real["per_layer"]]}


def make_root(tmp: Path, limit: float = SMOKE_LIMIT) -> Path:
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "src").symlink_to(REPO / "src")
    for name in ("granite-smoke", "mixtral-smoke"):
        shutil.copy(DATA / f"{name}.json", root / "bench" / "configs")
    shutil.copy(DATA / "tiny.json", root / "bench" / "mixes")
    for cell in CELLS:
        (root / "bench" / "limits" / f"{cell}.json").write_text(
            json.dumps({"worst_logit_gap": limit,
                        "check_requests": SMOKE_REQUESTS}))
    (root / "BENCHMARK.json").write_text(json.dumps(spec(), indent=1))
    return root
