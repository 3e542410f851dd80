"""The control of each cell's comparison, on the card at the cell's own
size: the float8 reference put in the program's place reads above one
of the cell's limits on each of three seeds, and the program on the same
seeds reads within all of them (``calibrate.readings``). Needs an NVIDIA card; skipped
without one. On the card, from the root of the repository:

    PYTHONPATH=src python -m pytest -q bench/tests/test_bench_control.py
"""
import json

import pytest
import torch

from bench import calibrate
from bench.tests.smoke import REPO

pytestmark = pytest.mark.requires_cuda

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    limits = json.loads((REPO / "bench" / "limits" / f"{cell}.json")
                        .read_text())
    limits = {k: v for k, v in limits.items() if k.endswith("_gap")}
    for r in calibrate.readings(REPO, cell, SEEDS, set(SEEDS)):
        assert r["bad_outputs"] == 0
        assert all(r[k] <= v for k, v in limits.items()), r
        assert any(r["control_" + k] > v for k, v in limits.items()), r
