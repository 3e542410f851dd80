"""The port's autotuner, co-design loop and compiled-workload DSE against
the JAX package's, on the CPU path: ``autotune``/``autotune_suite`` rows,
picks and cycles, the ``codesign`` joint frontier, a ``dse.search`` over
``Evaluator(workloads=)``, and the executor memo shared across calls.

Sizes are the compiler benchmark's fast ones (``FAST_SIZES``), so the
cycle fields are also held against ``benchmarks/baselines/
BENCH_compiler.json``, which ``chip_smoke.py`` holds the card's run
against.
"""
import json
from pathlib import Path

import numpy as np
import pytest

import repro.compiler as RC
from repro import dse as jax_dse
from repro.ggpu.engine import GGPUConfig as RGGPUConfig

import repro_torch.compiler as PC
from repro_torch import dse
from repro_torch.compiler.suite import FAST_SIZES, FAST_SPECS
from repro_torch.ggpu.engine import GGPUConfig

ROOT = Path(__file__).resolve().parents[1]
BASELINE = json.loads((ROOT / "benchmarks" / "baselines"
                       / "BENCH_compiler.json").read_text())
CPU = "cpu"
TUNE = ("copy", "vec_mul")


def _rows(rows):
    """Report rows without their host wall times."""
    return [{k: v for k, v in r.items() if "wall" not in k} for r in rows]


@pytest.fixture(scope="module")
def jax_tuned():
    return RC.autotune_suite(TUNE, RGGPUConfig(n_cus=2), sizes=FAST_SIZES,
                             space=RC.SMOKE_SPACE)


@pytest.fixture(scope="module")
def port_tuned():
    return PC.autotune_suite(TUNE, GGPUConfig(n_cus=2), sizes=FAST_SIZES,
                             space=PC.SMOKE_SPACE, device=CPU)


@pytest.mark.parametrize("name", TUNE)
def test_autotune_suite_equals_jax_and_baseline(name, jax_tuned, port_tuned):
    got, want = port_tuned[name], jax_tuned[name]
    assert got.report() == want.report()
    assert got.best_schedule.label() == want.best_schedule.label()
    assert got.best.prog.tobytes() == np.asarray(want.best.prog).tobytes()
    base = BASELINE["autotune"]["benches"][name]
    rep = got.report()
    for key in ("best_schedule", "default_cycles", "tuned_cycles",
                "n_candidates"):
        assert rep[key] == base[key], key
    assert [{k: c[k] for k in ("schedule", "cycles", "prog_len", "best")}
            for c in rep["candidates"]] == \
        [{k: c[k] for k in ("schedule", "cycles", "prog_len", "best")}
         for c in base["candidates"]]


@pytest.mark.parametrize("name,args,space", [
    ("fir", (32, 4), "coarsen"),
    ("reduction", (64, 8), "default"),
    ("xcorr", (16,), "smoke"),
    ("parallel_sel", (16,), "smoke"),
])
def test_autotune_rows_equal_jax(name, args, space):
    """One kernel per space: every candidate's cycles, program length and
    verification, and the pick."""
    spaces = {"coarsen": lambda pkg: pkg.ScheduleSpace(coarsen=(1, 2)),
              "default": lambda pkg: pkg.DEFAULT_SPACE,
              "smoke": lambda pkg: pkg.SMOKE_SPACE}
    want = RC.autotune(*RC.kernel_def(name, *args), RGGPUConfig(n_cus=2),
                       space=spaces[space](RC), name=name)
    got = PC.autotune(*PC.kernel_def(name, *args), GGPUConfig(n_cus=2),
                      space=spaces[space](PC), name=name, device=CPU)
    assert got.report() == want.report()
    assert all(c.verified for c in got.candidates)
    got.best.verify(got.best.random_inputs(seed=0), GGPUConfig(n_cus=2),
                    device=CPU)


def test_codesign_joint_frontier_equals_jax():
    """The compiler benchmark's co-design section (fast): copy and
    vec_mul, SMOKE_SPACE, 1 and 2 CUs at 500 and 667 MHz."""
    hands = RC.hand_benches(FAST_SIZES)
    rdefs = {n: RC.kernel_def(n, *RC.def_args(n, hands[n])) for n in TUNE}
    pdefs = {n: PC.kernel_def(n, *RC.def_args(n, hands[n])) for n in TUNE}
    want = RC.codesign(rdefs, jax_dse.enumerate_specs(**FAST_SPECS),
                       space=RC.SMOKE_SPACE)
    got = PC.codesign(pdefs, dse.enumerate_specs(**FAST_SPECS),
                      space=PC.SMOKE_SPACE, device=CPU)
    assert sorted(got.results) == sorted(want.results)
    assert _rows(got.report()) == _rows(want.report())
    pairs = sorted((jp.label(), jp.variant) for jp in got.frontier)
    assert pairs == sorted((jp.label(), jp.variant) for jp in want.frontier)
    base = BASELINE["codesign"]
    assert sorted(got.results) == base["schedules"]
    assert sum(len(r.points) for r in got.results.values()) == \
        base["n_points"]
    assert pairs == sorted((r["label"], r["schedule"])
                           for r in base["frontier"])


def _workloads(pkg, hands_pkg):
    compiled = pkg.dsl_benches(FAST_SIZES,
                               hands=hands_pkg.hand_benches(FAST_SIZES))
    wl = {n: b for n, b in compiled.items()
          if n in ("dsl_vec_mul", "dsl_reduction")}
    user = pkg.compile_kernel(lambda a, b: ((a - b) * a).seg_sum(32),
                              dict(a=512, b=512), name="user_segred")
    wl["dsl_user_segred"] = user.as_bench(seed=11)
    return wl


def test_compiled_workload_dse_equals_jax_and_baseline():
    """``dse.search`` over ``Evaluator(workloads=)`` (check=True): per
    point and bench cycles, both frontiers, and the artifact's exact
    fields against the baseline's nested ``dse``."""
    rwl, pwl = _workloads(RC, RC), _workloads(PC, PC)
    assert list(pwl) == list(rwl)
    for n in rwl:
        assert pwl[n].gpu_prog.tobytes() == rwl[n].gpu_prog.tobytes()
        assert pwl[n].gpu_mem.tobytes() == rwl[n].gpu_mem.tobytes()
    want = jax_dse.search(specs=jax_dse.enumerate_specs(**FAST_SPECS),
                          evaluator=jax_dse.Evaluator(
                              benches=(), workloads=rwl, check=True))
    ev = dse.Evaluator(benches=(), workloads=pwl, check=True, device=CPU)
    assert ev.bench_names == tuple(rwl)
    got = dse.search(specs=dse.enumerate_specs(**FAST_SPECS), evaluator=ev)
    assert _rows(got.report()) == _rows(want.report())
    for gp, wp in zip(got.points, want.points):
        for n in rwl:
            g, w = gp.per_bench[n], wp.per_bench[n]
            assert (g.cycles, g.analytic_cycles) == \
                (w.cycles, w.analytic_cycles)
    ref = min(got.frontier, key=lambda p: p.time_us)
    art = dse.dse_artifact(ref, got)
    base = BASELINE["dse"]
    for key in ("frontier", "analytic_frontier", "excluded_analytic",
                "reference"):
        assert art[key] == base[key], key
    for n, row in base["benches"].items():
        assert art["benches"][n]["cycles"] == row["cycles"], n


def test_evaluator_bench_names_and_content_keys():
    """Workloads join ``benches`` in order, without repeating a name
    already there; memo keys are content-addressed, so two evaluators
    over equal workloads share cycles."""
    k = PC.compile_kernel(lambda a: a * 3, dict(a=64), name="x3")
    wl = {"x3": k.as_bench(seed=1), "copy": k.as_bench(seed=2)}
    ev = dse.Evaluator(benches=("copy",), sizes={"copy": (16, 64)},
                       workloads=wl, device=CPU)
    rev = jax_dse.Evaluator(benches=("copy",), sizes={"copy": (16, 64)},
                            workloads={n: b for n, b in wl.items()})
    assert ev.bench_names == rev.bench_names == ("copy", "x3")
    assert ev._keys == rev._keys
    cfg = GGPUConfig(n_cus=2, max_steps=4000)
    ev.simulate(cfg)
    again = dse.Evaluator(benches=(), workloads={"x3": k.as_bench(seed=1)},
                          device=CPU)
    assert again.cache_size() == 1
    info, _ = again.cycles(cfg, "x3")
    assert info["cycles"] == ev.cycles(cfg, "x3")[0]["cycles"]


def test_autotune_cycle_cache_shared_across_calls():
    """The second search of the same kernel on the same device starts
    with every candidate's cycles memoized (the executors are keyed by
    device), and reports the same rows."""
    fn, shapes = PC.kernel_def("vec_mul", 32)
    cfg = GGPUConfig(n_cus=2)
    r1 = PC.autotune(fn, shapes, cfg, space=PC.SMOKE_SPACE,
                     name="vm_cache", device=CPU)
    r2 = PC.autotune(fn, shapes, cfg, space=PC.SMOKE_SPACE,
                     name="vm_cache", device=CPU)
    assert r2.cache_hits >= len(r2.candidates)
    assert [c.report() for c in r2.candidates] == \
        [c.report() for c in r1.candidates]


def test_tuning_entry_points_default_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, shapes = PC.kernel_def("copy", 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PC.autotune(fn, shapes, GGPUConfig(), space=PC.SMOKE_SPACE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PC.autotune_suite(("copy",), GGPUConfig(),
                          sizes={"copy": (16, 64)}, space=PC.SMOKE_SPACE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PC.codesign({"copy": (fn, shapes)},
                    dse.enumerate_specs(cus=(1,), freq_targets=(500.0,)),
                    space=PC.SMOKE_SPACE)
