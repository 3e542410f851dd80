"""The port's DSE stack against the JAX package's, exactly: GPUPlanner's
map and the 12-version Table I sweep (``core``), design points, Pareto
dominance, the ``Evaluator`` on shared executors, ``search`` and the
``BENCH_dse.json`` artifact (``dse``), all with ``device="cpu"``.

``src/repro_torch/dse/golden_dse.json`` holds the JAX package's result of
the nightly DSE grid's full axes (48 specs, 33 simulated configs) at
xcorr (16, 128), which ``chip_smoke.py`` holds the card's search against;
running this file as a script regenerates it from the JAX package:

    PYTHONPATH=src python tests/test_torch_dse.py
"""
import dataclasses
import functools
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro import dse as jax_dse
from repro.core import planner as jax_planner
from repro.core import ppa as jax_ppa
from repro.core import sram as jax_sram
from repro.ggpu import programs as jax_programs
from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro_torch import dse
from repro_torch.core import planner, ppa, sram
from repro_torch.ggpu.engine import GGPUConfig, run_kernel
from repro_torch.serve.executors import get_executor

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_chip_smoke()
SIZES = {smoke.DSE_BENCH: smoke.DSE_SIZES}


def _golden():
    return json.loads(smoke.GOLDEN_DSE.read_text())


# ---------------------------------------------------------------------------
# GPUPlanner and the PPA model (tests/test_planner.py on the port)
# ---------------------------------------------------------------------------

def _plan_dict(p):
    """Everything a plan holds, as plain data."""
    v = p.version
    return {"achieved": p.achieved, "reason": p.reason,
            "report": v.report(), "paths": v.paths(),
            "area": v.total_area_mm2(), "power": v.total_w(),
            "fmax": v.fmax_mhz(), "n_memories": v.n_memories(),
            "inventory": [dataclasses.asdict(m) for m in v.inventory],
            "map_log": [dataclasses.asdict(e) for e in p.map_log]}


@pytest.mark.parametrize("n_cus,freq", [(1, 500.0), (1, 667.0), (2, 590.0),
                                        (4, 667.0), (8, 667.0), (8, 750.0),
                                        (1, 2000.0), (3, 400.0)])
def test_plan_equals_reference(n_cus, freq):
    """The map, its log, the version's inventory, PPA and fmax: equal."""
    assert _plan_dict(planner.plan(n_cus, freq)) == \
        _plan_dict(jax_planner.plan(n_cus, freq))


def test_twelve_versions_equal_reference_and_table1_anchors():
    """The Table I sweep equals the reference's, version for version, and
    keeps tests/test_planner.py's anchors: freq-major order, the 37-block
    baseline, only 8CU@667 missing its target (interconnect, ~600 MHz),
    higher-frequency versions dividing more memories and paying area, the
    mean error against Table I under 25 %."""
    plans = planner.enumerate_versions()
    assert [_plan_dict(p) for p in plans] == \
        [_plan_dict(p) for p in jax_planner.enumerate_versions()]
    reqs = [(f, c) for f in (500.0, 590.0, 667.0) for c in (1, 2, 4, 8)]
    for p, (f, c) in zip(plans, reqs):
        assert p.version.n_cus == c
        if (c, f) != (8, 667.0):
            assert p.achieved and p.version.freq_mhz == f
    assert plans[0].version.n_memories() == 37
    assert plans[3].version.n_memories() == 28 * 8 + 9
    assert plans[8].version.n_memories() > plans[0].version.n_memories()
    stop = plans[-1]
    assert not stop.achieved and "interconnect" in stop.reason
    assert stop.map_log[-1].bottleneck == "interconnect"
    assert 595 <= stop.version.freq_mhz <= 605
    for c_ix in range(4):
        assert plans[8 + c_ix].version.total_area_mm2() > \
            plans[c_ix].version.total_area_mm2()
    errs = []
    for p, (f, _) in zip(plans, reqs):
        r = p.version.report()
        pap = ppa.PAPER_TABLE1[(r["n_cus"], int(f))]
        errs += [abs(r["total_area_mm2"] - pap["area"]) / pap["area"],
                 abs(r["total_w"] - pap["total"]) / pap["total"]]
    assert sum(errs) / len(errs) < 0.25
    assert ppa.PAPER_TABLE1 == jax_ppa.PAPER_TABLE1
    assert ppa.PAPER_LAYOUT_DERATE == jax_ppa.PAPER_LAYOUT_DERATE


def test_map_log_is_the_dynamic_spreadsheet():
    p = planner.plan(1, 667.0)
    assert p.achieved
    its = [e.iteration for e in p.map_log]
    assert its == sorted(its) and len(set(its)) == len(its)
    for e in p.map_log:
        assert set(e.paths) == {"memory", "logic", "interconnect"}
    assert p.map_log[0].bottleneck.startswith("memory:")
    assert p.map_log[0].action.startswith("divide")
    assert any("pipeline" in e.action for e in p.map_log)
    assert p.map_log[-1].action == "target met"
    fmaxes = [e.fmax_mhz for e in p.map_log]
    assert all(b >= a - 1e-9 for a, b in zip(fmaxes, fmaxes[1:]))


def test_baseline_and_linear_area():
    v = ppa.GGPUVersion(1, 500.0, ppa.baseline_inventory())
    assert 490 <= v.fmax_mhz() <= 530
    assert all(m.divided == 0 for m in v.inventory)
    areas = [planner.plan(c, 500.0).version.total_area_mm2()
             for c in (1, 2, 4, 8)]
    slope1, slope3 = areas[1] - areas[0], (areas[3] - areas[2]) / 4
    assert abs(slope1 - slope3) / slope1 < 0.1


def test_speedup_table_equals_reference():
    cyc = {"fir": {1: 694_000, 8: 169_000}, "copy": {2: 36_000}}
    scalar = {"fir": 542_000, "copy": 71_000}
    ratio = {"fir": 32.0, "copy": 64.0}
    assert planner.speedup_table(cyc, scalar, ratio) == \
        jax_planner.speedup_table(cyc, scalar, ratio)


@given(st.integers(5, 14), st.integers(2, 7))
@settings(max_examples=25, deadline=None)
def test_division_property(words_log2, bits_log2):
    """Dividing a macro never increases its access delay and always
    increases its area; the port's macro model equals the reference's."""
    m = sram.Macro("m", 2 ** words_log2, 2 ** bits_log2)
    r = jax_sram.Macro("m", 2 ** words_log2, 2 ** bits_log2)
    d = m.divide_words()
    assert sram.divided_path_delay(d) <= sram.divided_path_delay(m) + 1e-9
    assert d.area_mm2() > m.area_mm2() and d.count == 2 * m.count
    rd = r.divide_words()
    assert (sram.divided_path_delay(d), d.area_mm2(), d.leakage_mw(),
            d.dynamic_mw(667.0)) == (jax_sram.divided_path_delay(rd),
                                     rd.area_mm2(), rd.leakage_mw(),
                                     rd.dynamic_mw(667.0))
    if m.bits // 2 >= sram.MIN_BITS:
        assert m.divide_bits().delay_ns() == r.divide_bits().delay_ns()


@given(st.integers(1, 8), st.sampled_from([400.0, 500.0, 590.0, 667.0]))
@settings(max_examples=20, deadline=None)
def test_plan_postconditions(n_cus, freq):
    p = planner.plan(n_cus, freq)
    if p.achieved:
        assert p.version.fmax_mhz() >= freq - 1
    else:
        assert p.reason and p.map_log[-1].action.startswith("STOP")


# ---------------------------------------------------------------------------
# design points, dominance (tests/test_dse.py on the port)
# ---------------------------------------------------------------------------

def _point_dict(p):
    return {"label": p.label(), "config": dataclasses.asdict(p.config),
            "plan": _plan_dict(p.plan), "area": p.area_mm2,
            "power": p.power_w, "freq": p.freq_mhz}


@pytest.mark.parametrize("spec", [
    dict(n_cus=1, freq_target_mhz=667.0),
    dict(n_cus=8, freq_target_mhz=667.0),
    dict(n_cus=1, freq_target_mhz=667.0, pipeline_depth=0),
    dict(n_cus=4, freq_target_mhz=750.0, memsys="banked-iso", fuse=2),
    dict(n_cus=8, freq_target_mhz=590.0, memsys="banked"),
])
def test_design_point_equals_reference(spec):
    """The closed loop: the engine config carries the map's inserted
    stages and achieved (possibly derated) frequency, as the reference's
    does, field for field."""
    got = dse.design_point(dse.DesignSpec(**spec))
    want = jax_dse.design_point(jax_dse.DesignSpec(**spec))
    assert _point_dict(got) == _point_dict(want)
    if spec.get("pipeline_depth") == 0:
        assert got.config.pipeline_depth == 0 < got.version.pipelines
    if spec["n_cus"] == 8 and spec["freq_target_mhz"] == 667.0:
        assert not got.plan.achieved and 580 <= got.freq_mhz <= 620
        assert got.config.freq_mhz == got.version.freq_mhz


def test_memsys_inventory_area_coupling():
    areas = {}
    for ms in ("shared", "banked", "banked-iso"):
        inv = dse.memsys_inventory(ms, 8)
        assert [dataclasses.asdict(m) for m in inv] == \
            [dataclasses.asdict(m) for m in jax_dse.memsys_inventory(ms, 8)]
        areas[ms] = ppa.GGPUVersion(8, 500.0, inv).total_area_mm2()
    assert areas["shared"] < areas["banked-iso"] < areas["banked"]
    with pytest.raises(KeyError):
        dse.memsys_inventory("l3-victim", 8)


def test_dominance_and_frontier():
    assert dse.dominates((1, 1), (2, 1)) and dse.dominates((1, 1), (2, 2))
    assert not dse.dominates((1, 1), (1, 1))
    assert not dse.dominates((1, 2), (2, 1))
    with pytest.raises(ValueError):
        dse.dominates((1,), (1, 2))
    pts = [(1, 5), (2, 2), (5, 1), (3, 3), (2, 2)]
    assert dse.pareto_frontier(pts, key=lambda p: p) == \
        jax_dse.pareto_frontier(pts, key=lambda p: p) == \
        [(1, 5), (2, 2), (5, 1), (2, 2)]
    assert dse.pareto_frontier([], key=lambda p: p) == []
    assert dse.pareto_frontier([(4, 2)], key=lambda p: p) == [(4, 2)]


def test_enumerate_specs_equals_reference():
    for grid in ({}, smoke.DSE_SMOKE, smoke.DSE_NIGHTLY,
                 {"fuse": (1, 4), "pipeline_depths": (None, 0, 2)}):
        got = [dataclasses.asdict(s) for s in dse.enumerate_specs(**grid)]
        assert got == [dataclasses.asdict(s)
                       for s in jax_dse.enumerate_specs(**grid)]
    assert len(dse.enumerate_specs(**smoke.DSE_NIGHTLY)) == 48


# ---------------------------------------------------------------------------
# the pipeline-depth knob on the port
# ---------------------------------------------------------------------------

def test_depth_increases_cpi_not_results():
    """Deeper pipelines cost cycles but never change results; at depths
    0, 1 and 2 the 2-CU runs equal the golden file's (the JAX package's)
    stats for the same configs."""
    b = jax_programs._xcorr(*smoke.DSE_SIZES)
    golden = {p["pipeline_depth"]: p["stats"] for p in _golden()["points"]
              if p["label"] in ("2cu@500/shared/d0", "2cu@590/shared/d1",
                                "2cu@750~697/shared/d2")}
    cycles = {}
    for d in (0, 1, 2):
        mem, info = run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items,
                               GGPUConfig(n_cus=2, pipeline_depth=d),
                               device=CPU)
        np.testing.assert_array_equal(mem[b.gpu_out],
                                      b.ref(b.gpu_mem, b.gpu_n))
        assert {k: info[k] for k in smoke.STAT_KEYS} == golden[d]
        cycles[d] = info["cycles"]
    assert cycles[0] < cycles[1] < cycles[2]


def test_depth_batching_invariants():
    from repro_torch.ggpu.engine import run_kernel_batch, run_kernel_cohort
    b = jax_programs._xcorr(16, 128)
    cfg = GGPUConfig(n_cus=2, pipeline_depth=2)
    mem_s, i_s = run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items, cfg,
                            device=CPU)
    (mem_c, i_c), = run_kernel_cohort(b.gpu_prog, [b.gpu_mem], b.gpu_items,
                                      cfg, device=CPU)
    (mem_b, i_b), = run_kernel_batch([b.gpu_prog], [b.gpu_mem],
                                     [b.gpu_items], cfg, device=CPU)
    np.testing.assert_array_equal(mem_s, mem_c)
    np.testing.assert_array_equal(mem_s, mem_b)
    assert i_s["cycles"] == i_c["cycles"] == i_b["cycles"]


# ---------------------------------------------------------------------------
# Evaluator and search
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _search_result():
    """tests/test_dse.py's 24-spec search on the port."""
    specs = dse.enumerate_specs(cus=(1, 2, 4, 8),
                                freq_targets=(500.0, 667.0, 750.0),
                                memsys=("shared", "banked"))
    ev = dse.Evaluator(benches=(smoke.DSE_BENCH,), sizes=SIZES, device=CPU)
    return dse.search(specs=specs, evaluator=ev), ev


def test_search_equals_the_golden_grid():
    """The 24-spec search of tests/test_dse.py is a subset of the golden
    48-spec grid: each of its points equals the JAX package's point of the
    same label (planner fields, cycles, analytic cycles, stats), and its
    frontiers are the reference's frontiers of those points."""
    res, _ = _search_result()
    assert len(res.points) == 24
    golden = {p["label"]: p for p in _golden()["points"]}
    mine = smoke.dse_summary(res)
    for row in mine["points"]:
        assert row == golden[row["label"]], row["label"]
    # the reference's ranking of the same points
    ref = jax_dse.search(
        specs=jax_dse.enumerate_specs(cus=(1, 2, 4, 8),
                                      freq_targets=(500.0, 667.0, 750.0),
                                      memsys=("shared", "banked")),
        evaluator=_GoldenEvaluator())
    want = smoke.dse_summary(ref)
    for key in ("frontier", "analytic_frontier", "excluded_analytic"):
        assert mine[key] == want[key], key
    assert res.frontier and res.excluded_analytic
    front_ids = {id(p) for p in res.frontier}
    for p in res.excluded_analytic:
        assert id(p) not in front_ids
        assert any(dse.dominates((q.time_us, q.area_mm2),
                                 (p.time_us, p.area_mm2)) for q in res.points)
        assert p.point.config.pipeline_depth > 0
    for p in res.points:
        assert p.time_us >= p.analytic_time_us > 0
        assert p.energy_uj == pytest.approx(p.power_w * p.time_us)


def test_joint_frontier_equals_reference():
    """Two variants' search results ranked as one population: the same
    (point, variant) frontier as the reference's."""
    res, _ = _search_result()
    ref = jax_dse.search(
        specs=jax_dse.enumerate_specs(cus=(1, 2, 4, 8),
                                      freq_targets=(500.0, 667.0, 750.0),
                                      memsys=("shared", "banked")),
        evaluator=_GoldenEvaluator())
    slow = dataclasses.replace(res, points=[
        dataclasses.replace(p, time_us=p.time_us * 1.25)
        for p in res.points])
    jslow = dataclasses.replace(ref, points=[
        dataclasses.replace(p, time_us=p.time_us * 1.25)
        for p in ref.points])
    got = dse.joint_frontier({"base": res, "slow": slow})
    want = jax_dse.joint_frontier({"base": ref, "slow": jslow})
    assert [jp.label() for jp in got.frontier] == \
        [jp.label() for jp in want.frontier]
    assert [r["label"] for r in got.report()] == \
        [r["label"] for r in want.report()]
    assert all(jp.variant == "base" for jp in got.frontier)


class _GoldenEvaluator(jax_dse.Evaluator):
    """The JAX package's Evaluator with its simulations answered from the
    golden file (which the JAX package wrote): the reference's own
    evaluation and ranking code over the reference's cycles, without
    re-simulating 22 configs on the CPU."""

    def __init__(self):
        super().__init__(benches=(smoke.DSE_BENCH,), sizes=SIZES)
        self._golden = {}
        for p in _golden()["points"]:
            spec = _spec_of(p["label"])
            cfg = jax_dse.design_point(spec).config
            self._golden[cfg] = p["stats"]
            self._golden[dataclasses.replace(cfg, pipeline_depth=0)] = {
                **p["stats"], "cycles": p["analytic_cycles"]}

    def _simulate_config(self, cfg, names):
        pass

    def _lookup(self, cfg, bench):
        return dict(self._golden[cfg]), 0.0


def _spec_of(label):
    """The DesignSpec of a nightly-grid label (``8cu@667~601/shared/d1``)."""
    cus, rest = label.split("cu@")
    freq, memsys, _ = rest.split("/")
    return jax_dse.DesignSpec(n_cus=int(cus),
                              freq_target_mhz=float(freq.split("~")[0]),
                              memsys=memsys)


def test_evaluator_caches_configs():
    res, ev = _search_result()
    n_cached = ev.cache_size()
    ev.evaluate([p.point for p in res.points])
    assert ev.cache_size() == n_cached
    assert n_cached < 2 * len(res.points)


def test_evaluator_shares_executor_cycle_cache():
    cfg = GGPUConfig(n_cus=2)
    ev1 = dse.Evaluator(benches=("copy",), sizes={"copy": (16, 128)},
                        device=CPU)
    info1, _ = ev1.cycles(cfg, "copy")
    dispatches = get_executor(cfg, device=CPU).stats.dispatches
    ev2 = dse.Evaluator(benches=("copy",), sizes={"copy": (16, 128)},
                        device=CPU)
    info2, _ = ev2.cycles(cfg, "copy")
    assert get_executor(cfg, device=CPU).stats.dispatches == dispatches
    assert info2["cycles"] == info1["cycles"]
    want = jax_dse.Evaluator(benches=("copy",), sizes={"copy": (16, 128)}
                             ).cycles(JaxConfig(n_cus=2), "copy")[0]
    assert {k: v for k, v in info1.items()} == want


def test_evaluator_check_reverifies_despite_shared_memo():
    cfg = GGPUConfig(n_cus=2)
    ev1 = dse.Evaluator(benches=("vec_mul",), sizes={"vec_mul": (16, 128)},
                        device=CPU)
    ev1.cycles(cfg, "vec_mul")
    d0 = get_executor(cfg, device=CPU).stats.dispatches
    ev2 = dse.Evaluator(benches=("vec_mul",), sizes={"vec_mul": (16, 128)},
                        check=True, device=CPU)
    ev2.cycles(cfg, "vec_mul")
    assert get_executor(cfg, device=CPU).stats.dispatches == d0 + 1
    ev2.cycles(cfg, "vec_mul")
    assert get_executor(cfg, device=CPU).stats.dispatches == d0 + 1


def test_smoke_grid_artifact_equals_the_baseline(tmp_path):
    """The CI smoke grid on the port: its artifact's exact fields equal
    benchmarks/baselines/BENCH_dse.json (cycles, frontier membership,
    labels, planner fields) and the schema holds."""
    res = dse.search(specs=dse.enumerate_specs(**smoke.DSE_SMOKE),
                     evaluator=dse.Evaluator(benches=(smoke.DSE_BENCH,),
                                             sizes=SIZES, device=CPU))
    ref = min(res.frontier, key=lambda p: p.time_us)
    path = dse.write_artifact(tmp_path / "BENCH_dse.json", ref, res)
    art = json.loads(path.read_text())
    assert smoke.dse_artifact_mismatches(
        art, json.loads(smoke.BENCH_DSE.read_text())) == []
    assert art["benches"]["xcorr"]["cycles"] == 23118
    assert art["frontier"] == ["1cu@500/shared/d0", "1cu@667/shared/d1"]
    on_front = [r["label"] for r in art["points"] if r["on_frontier"]]
    assert set(on_front) == set(art["frontier"])
    for bench, row in art["benches"].items():
        assert set(row) == {"cycles", "sim_wall_s", "fmax_mhz", "area_mm2",
                            "perf_per_area", "time_us"}


def test_sweep_memsys_moved_and_shimmed():
    sweep = dse.sweep_memsys(bench="xcorr", n_cus=(1,), sizes=(16, 128),
                             device=CPU)
    assert set(sweep) == {(1, ms) for ms in ("shared", "banked",
                                             "banked-iso")}
    with pytest.warns(DeprecationWarning):
        legacy = planner.sweep_memsys(bench="xcorr", n_cus=(1,),
                                      sizes=(16, 128), device=CPU)
    assert {k: v["cycles"] for k, v in legacy.items()} == \
        {k: v["cycles"] for k, v in sweep.items()}
    golden = {(p["label"].split("/")[1]): p["stats"]
              for p in _golden()["points"]
              if p["label"].startswith("1cu@500/")}
    for (_, ms), info in sweep.items():
        assert {k: info[k] for k in golden[ms]} == golden[ms]


def test_search_device_belongs_to_the_evaluator():
    ev = dse.Evaluator(benches=("copy",), sizes={"copy": (16, 128)},
                       device=CPU)
    with pytest.raises(ValueError):
        dse.search(specs=[dse.DesignSpec()], evaluator=ev, device=CPU)


# ---------------------------------------------------------------------------
# the golden file
# ---------------------------------------------------------------------------

def test_golden_file_is_complete_and_matches_the_baseline():
    """The golden file covers the nightly grid in order, and its 2-point
    smoke subset agrees with benchmarks/baselines/BENCH_dse.json: labels,
    planner fields, time = cycles / fmax, and the reference point's
    cycles."""
    golden = _golden()
    assert golden["spec"] == smoke.dse_spec()
    labels = [p["label"] for p in golden["points"]]
    assert len(labels) == 48 == len(set(labels))
    assert labels == [jax_dse.design_point(s).label() for s in
                      jax_dse.enumerate_specs(**smoke.DSE_NIGHTLY)]
    base = json.loads(smoke.BENCH_DSE.read_text())
    by_label = {p["label"]: p for p in golden["points"]}
    for row in base["points"]:
        g = by_label[row["label"]]
        for key in ("achieved", "pipeline_depth", "fmax_mhz", "area_mm2",
                    "power_w"):
            assert g[key] == row[key], (row["label"], key)
        assert round(g["cycles"] / g["fmax_mhz"], 3) == row["time_us"]
        assert round(g["analytic_cycles"] / g["fmax_mhz"], 3) == \
            row["analytic_time_us"]
    assert by_label[base["reference"]]["cycles"] == \
        base["benches"]["xcorr"]["cycles"]


def test_golden_cheap_points_rederive_from_jax():
    """Two of the golden file's configs re-simulated by the JAX package."""
    golden = {p["label"]: p for p in _golden()["points"]}
    b = jax_programs._xcorr(*smoke.DSE_SIZES)
    for label in ("1cu@667/banked-iso/d1", "8cu@500/banked/d0"):
        cfg = jax_dse.design_point(_spec_of(label)).config
        _, info = jax_run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items, cfg)
        assert {k: info[k] for k in smoke.STAT_KEYS} == \
            golden[label]["stats"]


def main() -> None:
    ev = jax_dse.Evaluator(benches=(smoke.DSE_BENCH,), sizes=SIZES)
    res = jax_dse.search(specs=jax_dse.enumerate_specs(**smoke.DSE_NIGHTLY),
                         evaluator=ev)
    golden = {"spec": smoke.dse_spec(), **smoke.dse_summary(res)}
    smoke.GOLDEN_DSE.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {smoke.GOLDEN_DSE}: {len(golden['points'])} points, "
          f"frontier {golden['frontier']}", file=sys.stderr)


if __name__ == "__main__":
    main()
