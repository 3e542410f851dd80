"""The golden file of the port's on-card smoke run.

``src/repro_torch/ggpu/golden_runs.json`` holds the JAX reference's exact
result (cycles, stats, steps, sha256 of the final memory) of every launch
``chip_smoke.py`` makes at Table III size, so the card's run is checked
against the reference without JAX on that machine. These tests keep the
file complete and true; running this file as a script regenerates it from
the JAX package:

    PYTHONPATH=src python tests/test_torch_golden.py
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.ggpu import programs as jax_programs
from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.ggpu.engine import ScalarConfig as JaxScalar
from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import GGPUConfig, ScalarConfig, run_kernel

ROOT = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_chip_smoke()
RUNS = {r.key: r for r in smoke.GOLDEN_RUNS}
CHEAP = ["8cu/shared/copy", "8cu/shared/div_int", "8cu/shared/fir",
         "8cu/shared/reduction"]


def _golden():
    return json.loads(smoke.GOLDEN.read_text())


def jax_summary(run):
    """The JAX reference's golden entry for ``run``."""
    prog, mem0, n, _, _ = smoke.launch(run, jax_programs.all_benches())
    cfg = smoke.make_config(run, JaxConfig, JaxScalar)
    return smoke.summary(*jax_run_kernel(prog, mem0, n, cfg))


def test_every_run_has_a_golden_entry():
    golden = _golden()
    assert len(RUNS) == len(smoke.GOLDEN_RUNS)      # keys are unique
    for key in RUNS:
        assert key in golden, key
        assert set(golden[key]) == set(smoke.STAT_KEYS) | {"mem_sha256"}
        assert golden[key]["steps"] > 0


def test_port_benches_equal_the_reference_benches():
    """The port's own copy of the bench builders gives the reference's
    programs, memory images, slices and sizes at Table III size."""
    ours, theirs = programs.all_benches(), jax_programs.all_benches()
    assert list(ours) == [n for n in theirs if n in ours]
    for name, b in ours.items():
        r = theirs[name]
        for field in ("gpu_prog", "gpu_mem", "scalar_prog", "scalar_mem"):
            np.testing.assert_array_equal(getattr(b, field),
                                          getattr(r, field))
        for field in ("gpu_items", "gpu_out", "scalar_out", "gpu_n",
                      "scalar_n"):
            assert getattr(b, field) == getattr(r, field), (name, field)
        np.testing.assert_array_equal(b.ref(b.gpu_mem, b.gpu_n),
                                      r.ref(r.gpu_mem, r.gpu_n))


@pytest.mark.parametrize("key", CHEAP)
def test_cheap_entries_rederive_from_jax(key):
    assert jax_summary(RUNS[key]) == _golden()[key]


@pytest.mark.parametrize("key", ["8cu/shared/div_int", "8cu/shared/copy"])
def test_port_cpu_path_reproduces_golden(key):
    run = RUNS[key]
    prog, mem0, n, out, expected = smoke.launch(run, programs.all_benches())
    cfg = smoke.make_config(run, GGPUConfig, ScalarConfig)
    mem, info = run_kernel(prog, mem0, n, cfg, device="cpu")
    np.testing.assert_array_equal(mem[out], expected)
    assert smoke.summary(mem, info) == _golden()[key]


def main() -> None:
    golden = {}
    for key, run in RUNS.items():
        golden[key] = jax_summary(run)
        print(key, golden[key], file=sys.stderr, flush=True)
    smoke.GOLDEN.write_text(json.dumps(golden, indent=1, sort_keys=True)
                            + "\n")


if __name__ == "__main__":
    main()
