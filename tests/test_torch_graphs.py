"""The port's kernel graphs (``repro_torch.compiler.compile_graph`` and
``repro_torch.serve.graphs``) against the JAX package's on the CPU path:
the stage split at reduction boundaries (byte-identical stage programs),
``run_program`` against the oracle and both host-staged ways, the
stage-major fold's dispatch count, interleaving with other traffic, a
quarantined ancestor surfacing as ``None``, and a ``Fleet`` that
colocates a graph's stages and learns per-(kernel, schedule) times —
the cases of ``tests/test_graphs.py`` run through both packages."""
import numpy as np
import pytest
from test_torch_parity import spinner

import repro.compiler as RC
from repro.ggpu.engine import GGPUConfig as RGGPUConfig
import repro.serve as RS

import repro_torch.compiler as PC
from repro_torch import convert
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import GGPUConfig
from repro_torch.serve import (Dep, DependencyError, Fleet, GraphTickets,
                               Request, Scheduler, extract_outputs,
                               run_chains_host_staged, run_program,
                               run_program_host_staged,
                               run_programs_host_staged, submit_program,
                               submit_programs)

CPU = "cpu"
CFG = dict(n_cus=2)
N, SEG = 64, 16


def _mrs(pkg, **kw):
    """3-stage map -> segmented reduce -> scale chain."""
    return pkg.compile_graph(lambda a, b: (a * b).seg_sum(SEG) * 3 + 1,
                             {"a": N, "b": N}, name="mrs", **kw)


@pytest.fixture(scope="module")
def program():
    return _mrs(PC)


@pytest.fixture(scope="module")
def jax_program():
    return _mrs(RC)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(-50, 50, N).astype(np.int32),
            "b": rng.integers(-50, 50, N).astype(np.int32)}


def _sched(**kw):
    return Scheduler(GGPUConfig(**CFG), device=CPU, **kw)


def _same_program(got, want):
    assert got.name == want.name and got.in_sizes == want.in_sizes
    assert got.sources == want.sources
    assert [ck.name for ck in got.stages] == [ck.name for ck in want.stages]
    for g, w in zip(got.stages, want.stages):
        assert g.prog.tobytes() == np.asarray(w.prog, np.int32).tobytes()
        assert g.scalar_prog.tobytes() == \
            np.asarray(w.scalar_prog, np.int32).tobytes()
        assert (g.out, g.n_items, g.layout, g.schedule.label()) == \
            (w.out, w.n_items, w.layout, w.schedule.label())
    carried = convert.program_from_reference(want)
    ins = want.random_inputs(seed=5)
    np.testing.assert_array_equal(carried.reference(ins),
                                  want.reference(ins))


GRAPHS = {
    "map-reduce-scale": (lambda a, b: (a * b).seg_sum(SEG) * 3 + 1,
                         {"a": N, "b": N}),
    "single-stage": (lambda a, b: a * b + 1, {"a": 16, "b": 16}),
    "chained-reductions": (lambda a: (a * 2).seg_sum(8).seg_sum(4),
                           {"a": 64}),
    "reduce-of-input": (lambda a: a.seg_sum(8) + 5, {"a": 64}),
}


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_compile_graph_equals_jax_and_runs(case):
    """Stage split, wiring and stage programs equal the JAX package's;
    ``run_program``, ``run_host`` and the host-staged way all equal the
    oracle on the port's CPU path."""
    fn, shapes = GRAPHS[case]
    want = RC.compile_graph(fn, shapes, name=case.replace("-", "_"))
    got = PC.compile_graph(fn, shapes, name=case.replace("-", "_"))
    _same_program(got, want)
    ins = got.random_inputs(seed=1)
    ref = got.reference(ins)
    np.testing.assert_array_equal(ref, want.reference(ins))
    np.testing.assert_array_equal(run_program(_sched(), got, ins), ref)
    np.testing.assert_array_equal(
        got.run_host(ins, GGPUConfig(**CFG), device=CPU), ref)
    np.testing.assert_array_equal(
        run_program_host_staged(_sched(), got, ins), ref)


def test_compile_graph_splits_at_reduction(program, jax_program):
    assert [ck.name for ck in program.stages] == ["mrs_s0", "mrs_s1",
                                                  "mrs_s2"]
    kinds = [sorted(k for k, _ in program.sources[i].values())
             for i in range(3)]
    assert kinds == [["input", "input"], ["stage"], ["stage"]]
    ins = _inputs(0)
    expect = ((ins["a"].astype(np.int64) * ins["b"])
              .reshape(-1, SEG).sum(axis=1) * 3 + 1).astype(np.int32)
    np.testing.assert_array_equal(program.reference(ins), expect)
    _same_program(program, jax_program)


def test_tuned_stage_schedules_equal_jax():
    sched = {0: (2, False), 2: (2, True)}
    want = _mrs(RC, schedules={i: RC.Schedule(coarsen=c, branchy=b)
                               for i, (c, b) in sched.items()})
    got = _mrs(PC, schedules={i: PC.Schedule(coarsen=c, branchy=b)
                              for i, (c, b) in sched.items()})
    _same_program(got, want)
    assert [ck.schedule.label() for ck in got.stages] == \
        ["c2+select", "c1", "c2"]
    ins = _inputs(6)
    np.testing.assert_array_equal(run_program(_sched(), got, ins),
                                  want.reference(ins))


def test_run_program_matches_reference_and_host_staged(program):
    ins = _inputs(1)
    sched = _sched()
    out = run_program(sched, program, ins)
    ref = program.reference(ins)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        run_program_host_staged(_sched(), program, ins), ref)
    assert sched.quarantined == {}
    # interior stages never declared a download
    assert sched._resident == {} and len(sched) == 0


def test_submit_programs_folds_stage_major(program, jax_program):
    """N instances stage-major: every stage folds into one cohort
    dispatch (as in the JAX package's scheduler), every output equals
    the oracle, and both host-staged ways agree."""
    n_inst = 4
    ins = [_inputs(10 + i) for i in range(n_inst)]
    refs = [program.reference(i) for i in ins]
    sched = _sched(max_batch=n_inst)
    d0 = sched.executor.stats.dispatches
    handles = submit_programs(sched, program, ins)
    results = sched.drain()
    outs = extract_outputs(results, handles)
    assert sched.executor.stats.dispatches - d0 == len(program.stages)
    jsched = RS.Scheduler(RGGPUConfig(**CFG), max_batch=n_inst)
    j0 = jsched.executor.stats.dispatches
    jhandles = RS.submit_programs(jsched, jax_program, ins)
    jresults = jsched.drain()
    assert jsched.executor.stats.dispatches - j0 == \
        sched.executor.stats.dispatches - d0
    assert [h.stages for h in handles] == [h.stages for h in jhandles]
    for g, w in zip(results, jresults):
        assert g.info["ticket"] == w.info["ticket"]
        assert {k: g.info[k] for k in ("cycles", "steps", "instrs")} == \
            {k: int(w.info[k]) for k in ("cycles", "steps", "instrs")}
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    for o, r in zip(run_chains_host_staged(_sched(), program, ins), refs):
        np.testing.assert_array_equal(o, r)
    for o, r in zip(run_programs_host_staged(_sched(), program, ins), refs):
        np.testing.assert_array_equal(o, r)


def test_submit_program_interleaves_with_other_traffic(program):
    """Graph requests coexist with plain launches in one drain."""
    b = programs.build("copy", 16, 128)
    sched = _sched()
    t_plain = sched.submit(b.gpu_prog, b.gpu_mem, b.gpu_items)
    ins = _inputs(2)
    handle = submit_program(sched, program, ins, tag="g")
    results = sched.drain()
    tickets = [r.info["ticket"] for r in results]
    assert t_plain in tickets and handle.final in tickets
    np.testing.assert_array_equal(
        extract_outputs(results, [handle])[0], program.reference(ins))
    np.testing.assert_array_equal(
        results[tickets.index(t_plain)].mem[b.gpu_out],
        b.ref(b.gpu_mem, b.gpu_n))
    assert f"g:{program.stages[-1].name}" in \
        {r.info.get("tag") for r in results}


def test_graph_quarantine_surfaces_as_none(program):
    """A quarantined ancestor leaves that chain's final output as
    ``None`` while an independent instance completes in the same
    drain."""
    b = programs.build("copy", 16, 128)
    sched = Scheduler(GGPUConfig(n_cus=2, max_steps=5000), device=CPU)
    t_bad = sched.submit(spinner(), np.zeros(8, np.int32), 8)
    t_leaf = sched.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                          deps=[Dep(t_bad, (0, 4), (0, 4))])
    ins = _inputs(3)
    healthy = submit_program(sched, program, ins)
    outs = extract_outputs(sched.drain(),
                           [GraphTickets([t_bad, t_leaf]), healthy])
    assert outs[0] is None
    np.testing.assert_array_equal(outs[1], program.reference(ins))
    assert isinstance(sched.quarantined[t_leaf].error, DependencyError)
    with pytest.raises(RuntimeError, match="did not complete"):
        bad = Scheduler(GGPUConfig(n_cus=2, max_steps=3), device=CPU)
        run_program(bad, program, ins)


def test_fleet_colocates_graph_and_learns_schedules(program, jax_program):
    """All stages land on one device, as in the JAX package's fleet; the
    learned table holds the same (device, kernel, schedule) keys and
    times; a dep on a ticket the fleet never issued is rejected."""
    devices = [("wide", dict(n_cus=8)), ("narrow", dict(n_cus=1))]
    fleet = Fleet([(n, GGPUConfig(**c)) for n, c in devices], device=CPU)
    jfleet = RS.Fleet([(n, RGGPUConfig(**c)) for n, c in devices])
    ins = _inputs(4)
    out = run_program(fleet, program, ins)
    np.testing.assert_array_equal(out, program.reference(ins))
    np.testing.assert_array_equal(RS.run_program(jfleet, jax_program, ins),
                                  out)
    assert len(set(fleet.placement.values())) == 1
    assert fleet.placement == jfleet.placement
    assert fleet._learned == jfleet._learned
    for dev, kk, sched in fleet._learned:
        assert dev in ("wide", "narrow")
        assert isinstance(kk, tuple) and sched == "c1"
    b = programs.build("copy", 16, 128)
    with pytest.raises(ValueError):
        fleet.submit_request(Request(b.gpu_prog, b.gpu_mem, b.gpu_items,
                                     deps=(Dep(10 ** 6, (0, 4), (0, 4)),)))


def test_fleet_learned_table_keys_tuned_schedules():
    """A tuned stage's schedule label keys its learned time apart from
    the default lowering's."""
    tuned = _mrs(PC, schedules={0: PC.Schedule(coarsen=2)})
    fleet = Fleet([("only", GGPUConfig(**CFG))], device=CPU)
    ins = _inputs(8)
    np.testing.assert_array_equal(run_program(fleet, tuned, ins),
                                  tuned.reference(ins))
    assert sorted(k[2] for k in fleet._learned) == ["c1", "c1", "c2"]
    assert all(t > 0 for t in fleet._learned.values())
