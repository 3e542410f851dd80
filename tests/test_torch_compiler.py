"""The port's tensor-expression compiler (``repro_torch.compiler``) against
the JAX package's (``repro.compiler``) on the CPU.

The compiler is host code: tracing, folding, lowering and the numpy
oracle. What it must reproduce is the artefact, byte for byte: the SIMT
and scalar programs, the memory layout, the memory image and the oracle's
output, for the eight suite benches at the registry's smoke sizes and the
compiler benchmark's fast sizes under every schedule of ``DEFAULT_SPACE``,
for ``tests/test_compiler_diff.py``'s random expressions replayed over
its seeds, and for the ``CompileError`` cases. ``verify`` on the port's
CPU path must give the cycles and stats the JAX engine's ``run_kernel``
gives for the same program.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

import repro.compiler as RC
from repro.compiler import ir as rir
from repro.compiler import opt as ropt
from repro.ggpu.engine import GGPUConfig as RGGPUConfig
from repro.ggpu.engine import ScalarConfig as RScalarConfig
from repro.ggpu.engine import run_kernel as jax_run_kernel

import repro_torch.compiler as PC
from repro_torch import convert
from repro_torch.compiler import ir as pir
from repro_torch.compiler import opt as popt
from repro_torch.compiler.suite import FAST_SIZES
from repro_torch.ggpu import isa, programs
from repro_torch.ggpu.engine import GGPUConfig, ScalarConfig

sys.path.insert(0, os.path.dirname(__file__))
from test_compiler_diff import N, _random_exprfn, _random_schedule  # noqa: E402

CPU = "cpu"
SIZE_SETS = {"smoke": dict(programs.SMOKE_SIZES), "fast": FAST_SIZES}
STAT_KEYS = ("cycles", "instrs", "mem_ops", "hits", "misses", "steps")


def _def_args(size_set, name, scalar=False):
    b = programs.build(name, *SIZE_SETS[size_set][name])
    return PC.def_args(name, b, scalar=scalar)


def _suite_cases():
    """(size set, bench, schedule label) for every DEFAULT_SPACE schedule
    valid for the bench at that size."""
    cases = []
    for size_set in SIZE_SETS:
        for name in programs.LEGACY_ORDER:
            fn, shapes = PC.kernel_def(name, *_def_args(size_set, name))
            out_len = PC.compile_kernel(fn, shapes).kernel.out_len
            cases += [(size_set, name, s.label())
                      for s in PC.DEFAULT_SPACE.candidates(out_len)]
    return cases


def _schedule(cls, label):
    parts = label.split("+")
    return cls(coarsen=int(parts[0][1:]), hoist="nohoist" not in parts,
               branchy="select" not in parts, peel="nopeel" not in parts)


def _assert_same_kernel(rk, pk, seed=3):
    """Byte-identical programs, the same layout, memory image and oracle
    output; the reference kernel carried across by ``convert`` too."""
    for got, want in ((pk.prog, rk.prog), (pk.scalar_prog, rk.scalar_prog)):
        assert got.dtype == np.int32 and got.shape == want.shape
        assert got.tobytes() == np.asarray(want, np.int32).tobytes()
    assert pk.name == rk.name and pk.n_items == rk.n_items
    assert pk.out == rk.out and pk.layout == rk.layout
    assert pk.mem_size == rk.mem_size
    assert pk.schedule.label() == rk.schedule.label()
    ins = rk.random_inputs(seed=seed)
    np.testing.assert_array_equal(pk.build_mem(ins), rk.build_mem(ins))
    want = rk.reference(ins)
    np.testing.assert_array_equal(pk.reference(ins), want)
    carried = convert.compiled_from_reference(rk)
    assert carried.prog.tobytes() == pk.prog.tobytes()
    np.testing.assert_array_equal(carried.reference(ins), want)
    return ins


def _same_run(rk, pk, cfg_fields, ins, scalar=False):
    """The port's ``verify`` on the CPU path and the JAX engine's
    ``run_kernel`` on the same program and image: equal output, cycles
    and stats."""
    pcfg = (ScalarConfig if scalar else GGPUConfig)(**cfg_fields)
    rcfg = (RScalarConfig if scalar else RGGPUConfig)(**cfg_fields)
    info = pk.verify(ins, pcfg, scalar=scalar, device=CPU)
    prog = rk.scalar_prog if scalar else rk.prog
    mem, want = jax_run_kernel(prog, rk.build_mem(ins),
                               1 if scalar else rk.n_items, rcfg)
    np.testing.assert_array_equal(np.asarray(mem)[rk.out],
                                  rk.reference(ins))
    assert {k: info[k] for k in STAT_KEYS} == \
        {k: int(want[k]) for k in STAT_KEYS}
    return info


# -- the suite, every schedule -------------------------------------------------

@pytest.mark.parametrize("size_set,name,label", _suite_cases(),
                         ids=lambda v: str(v))
def test_suite_schedule_programs_identical(size_set, name, label):
    args = _def_args(size_set, name)
    rfn, rshapes = RC.kernel_def(name, *args)
    pfn, pshapes = PC.kernel_def(name, *args)
    assert pshapes == rshapes
    rk = RC.compile_kernel(rfn, rshapes, name=name,
                           schedule=_schedule(RC.Schedule, label))
    pk = PC.compile_kernel(pfn, pshapes, name=name,
                           schedule=_schedule(PC.Schedule, label))
    _assert_same_kernel(rk, pk)


@pytest.mark.parametrize("size_set", sorted(SIZE_SETS))
def test_dsl_benches_identical(size_set):
    """``dsl_benches`` records: compiled programs in the hand benches'
    images, equal field by field; ``compile_pair``'s scalar kernels too."""
    sizes = SIZE_SETS[size_set]
    want = RC.dsl_benches(sizes)
    got = PC.dsl_benches(sizes)
    assert list(got) == list(want)
    for n, w in want.items():
        g = got[n]
        for f in ("gpu_prog", "gpu_mem", "scalar_prog", "scalar_mem"):
            assert getattr(g, f).tobytes() == \
                np.asarray(getattr(w, f), np.int32).tobytes(), (n, f)
        for f in ("name", "gpu_items", "gpu_out", "scalar_out", "gpu_n",
                  "scalar_n"):
            assert getattr(g, f) == getattr(w, f), (n, f)
        np.testing.assert_array_equal(g.ref(g.gpu_mem, g.gpu_n),
                                      w.ref(w.gpu_mem, w.gpu_n))
    hands = RC.hand_benches(sizes)
    for name, b in hands.items():
        (rg, rs), (pg, ps) = RC.compile_pair(name, b), PC.compile_pair(
            name, PC.hand_benches({name: sizes[name]})[name])
        _assert_same_kernel(rg, pg)
        _assert_same_kernel(rs, ps)


@pytest.mark.parametrize("name", programs.LEGACY_ORDER)
def test_suite_verify_cycles_equal_jax_engine(name):
    """Each compiled bench at the smoke sizes, SIMT on 2 CUs and the
    scalar program on the scalar machine: the port's ``verify`` (CPU)
    against the JAX engine, output, cycles and stats."""
    args = _def_args("smoke", name)
    rk = RC.compile_kernel(*RC.kernel_def(name, *args), name=name)
    pk = PC.compile_kernel(*PC.kernel_def(name, *args), name=name)
    ins = _assert_same_kernel(rk, pk, seed=11)
    _same_run(rk, pk, {"n_cus": 2}, ins)
    sargs = _def_args("smoke", name, scalar=True)
    rs = RC.compile_kernel(*RC.kernel_def(name, *sargs), name=name)
    ps = PC.compile_kernel(*PC.kernel_def(name, *sargs), name=name)
    _same_run(rs, ps, {}, _assert_same_kernel(rs, ps, seed=12), scalar=True)


# -- random expressions (tests/test_compiler_diff.py's generator) -------------

def _both(seed_rng, name, schedule_label=None):
    """Compile one random expression in both packages. The generator
    draws at trace time too, so each package traces a fresh generator
    from the same seed."""
    out = []
    for pkg in (RC, PC):
        fn = _random_exprfn(np.random.default_rng(seed_rng))
        sched = None if schedule_label is None \
            else _schedule(pkg.Schedule, schedule_label)
        out.append(pkg.compile_kernel(fn, dict(a=N, b=N), name=name,
                                      schedule=sched))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_random_expressions_identical(seed):
    rk, pk = _both(100 + seed, f"rand{seed}")
    ins = _assert_same_kernel(rk, pk, seed=seed)
    _same_run(rk, pk, {"n_cus": 1}, ins)


@pytest.mark.parametrize("seed", range(4))
def test_random_expression_random_schedule_identical(seed):
    rng = np.random.default_rng(500 + seed)
    fn = _random_exprfn(rng)
    k0 = RC.compile_kernel(fn, dict(a=N, b=N), name=f"sched{seed}")
    label = _random_schedule(rng, k0.kernel.out_len).label()
    rk, pk = _both(500 + seed, f"sched{seed}", label)
    ins = _assert_same_kernel(rk, pk, seed=seed)
    _same_run(rk, pk, {"n_cus": 2}, ins)


def _mixed(dsl):
    return lambda a, b: (dsl.stencil(a, [1, 1], [-1, 1]) * b + 3).seg_sum(8)


@pytest.mark.parametrize("machine", ["scalar", "2cu-shared", "2cu-banked"])
def test_fixed_expression_random_schedules(machine):
    """The diff suite's guarded mixed expression under the first two of
    its random schedules (seed 1234), on the scalar machine and 2 CUs of
    each memory system."""
    rng = np.random.default_rng(1234)
    for i in range(2):
        label = _random_schedule(rng, out_len=N // 8).label()
        rk = RC.compile_kernel(_mixed(RC.dsl), dict(a=N, b=N), name="mixed",
                               schedule=_schedule(RC.Schedule, label))
        pk = PC.compile_kernel(_mixed(PC.dsl), dict(a=N, b=N), name="mixed",
                               schedule=_schedule(PC.Schedule, label))
        ins = _assert_same_kernel(rk, pk, seed=50 + i)
        if machine == "scalar":
            _same_run(rk, pk, {}, ins, scalar=True)
        else:
            _same_run(rk, pk, {"n_cus": 2,
                               "memsys": machine.split("-")[1]}, ins)


def test_edge_values_and_wrapping_constants():
    """Extreme operands (wraparound, INT32 edges, zero divisors) and
    constants beyond int32, which wrap at construction."""
    fn = (lambda a, b: ((a * b) ^ (a // b)) + (a % b))
    rk = RC.compile_kernel(fn, dict(a=N, b=N), name="edges")
    pk = PC.compile_kernel(fn, dict(a=N, b=N), name="edges")
    _assert_same_kernel(rk, pk)
    rng = np.random.default_rng(0)
    ins = {"a": rng.choice(np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31,
                                     12345, -54321], np.int32), N),
           "b": rng.choice(np.array([0, 1, 3, -3, 2 ** 31 - 1],
                                    np.int32), N)}
    _same_run(rk, pk, {"n_cus": 1}, ins)
    wrap = (lambda a: (a < (1 << 31)) + a // (1 << 32) + (a * (1 << 32)))
    rk = RC.compile_kernel(wrap, dict(a=16), name="wrap")
    pk = PC.compile_kernel(wrap, dict(a=16), name="wrap")
    _assert_same_kernel(rk, pk)
    assert popt._as_expr(1 << 31) == pir.Const(-2 ** 31)


# -- IR and optimizer units against the reference ------------------------------

FOLDS = [("add", 2 ** 31 - 1, 1), ("div", -7, 2), ("div", 5, 0),
         ("rem", -5, 3), ("mul", 1 << 20, 1 << 20), ("srl", -8, 1),
         ("sra", -5, 1), ("shl", 3, 40), ("slt", -1, 0), ("rem", 7, 0),
         ("div", -2 ** 31, -1)]


@pytest.mark.parametrize("op,a,b", FOLDS)
def test_constant_folding_equal(op, a, b):
    assert popt.binop(op, pir.Const(a), pir.Const(b)).v == \
        ropt.binop(op, rir.Const(a), rir.Const(b)).v


def test_identities_strength_reduction_and_cse():
    for pkg_ir, pkg_opt in ((rir, ropt), (pir, popt)):
        x = pkg_ir.Item()
        assert pkg_opt.add(x, 0) is x and pkg_opt.mul(x, 1) is x
        assert pkg_opt.add(pkg_opt.add(x, 5), 7) == \
            pkg_ir.Bin("add", x, pkg_ir.Const(12))
        assert pkg_opt.mul(x, 8) == pkg_ir.Bin("shl", x, pkg_ir.Const(3))
        assert pkg_opt.div(x, 8) == pkg_ir.Bin("sra", x, pkg_ir.Const(3))
        assert pkg_opt.rem(x, 8) == pkg_ir.Bin("and", x, pkg_ir.Const(7))
        a = pkg_opt.mul(pkg_opt.add(x, 3), pkg_opt.add(x, 3))
        assert pkg_opt.use_counts([a])[
            pkg_ir.Bin("add", x, pkg_ir.Const(3))] == 2
    vals = np.array([-2 ** 31, -5, -1, 0, 1, 7, 2 ** 31 - 1], np.int64)
    for op in pir.BIN_OPS:
        for b in (np.int64(0), np.int64(3), np.int64(-3), np.int64(33)):
            np.testing.assert_array_equal(pir._eval_bin(op, vals, b),
                                          rir._eval_bin(op, vals, b))


def test_fusion_and_shift_lowering():
    k = PC.compile_kernel(lambda a, b, c: (a * b + c) ^ (a >> 2),
                          dict(a=64, b=64, c=64), name="chain")
    ops = list(k.prog[:, 0])
    assert ops.count(isa.LW) == 3 and ops.count(isa.SW) == 1
    info = k.verify(k.random_inputs(seed=1), GGPUConfig(n_cus=2),
                    device=CPU)
    assert info["mem_ops"] == 4 * 64
    k = PC.compile_kernel(lambda a: a * 8, dict(a=64))
    assert isa.SLLI in set(k.prog[:, 0]) and isa.MUL not in set(k.prog[:, 0])


# -- CompileError: raised where the reference raises ---------------------------

def _deep(a):
    terms = [a + (i + 1) for i in range(40)]
    s1, s2 = terms[0], terms[0]
    for t in terms[1:]:
        s1 = s1 + t
    for t in terms[1:]:
        s2 = s2 ^ t
    return s1 + s2


def _scatter(pkg, addr, coarsen=1):
    return lambda: pkg.compile_kernel(
        lambda a: pkg.ScatterTensor(4, addr(pkg), lambda i: a.elem(i)),
        dict(a=4), coarsen=coarsen).reference(
            {"a": np.arange(4, dtype=np.int32)})


ERRORS = {
    "shape mismatch": lambda pkg: pkg.compile_kernel(
        lambda a, b: a + b, dict(a=8, b=16)),
    "segment size": lambda pkg: pkg.compile_kernel(
        lambda a: a.seg_sum(3), dict(a=8)),
    "missing shape": lambda pkg: pkg.compile_kernel(lambda a: a, dict(b=8)),
    "coarsen no divisor": lambda pkg: pkg.compile_kernel(
        lambda a: a, dict(a=8), coarsen=3),
    "schedule and coarsen": lambda pkg: pkg.compile_kernel(
        lambda a: a, dict(a=8), coarsen=2,
        schedule=pkg.Schedule(coarsen=4)),
    "coarsen below 1": lambda pkg: pkg.Schedule(coarsen=0),
    "input length": lambda pkg: pkg.compile_kernel(
        lambda a: a, dict(a=8)).build_mem({"a": np.zeros(9, np.int32)}),
    "missing input": lambda pkg: pkg.compile_kernel(
        lambda a, b: a + b, dict(a=8, b=8)).reference(
            {"a": np.zeros(8, np.int32)}),
    "out of registers": lambda pkg: pkg.compile_kernel(_deep, dict(a=8)),
    "store collision": lambda pkg: _scatter(
        pkg, lambda p: (lambda i: ir_of(p).Const(0)))(),
    "cross-item collision": lambda pkg: _scatter(
        pkg, lambda p: (lambda i: opt_of(p).div(i, 3)), coarsen=2)(),
    "graph stage schedule": lambda pkg: pkg.compile_graph(
        lambda a: a.seg_sum(4), {"a": 16}, schedules={5: pkg.Schedule()}),
    "codesign without workloads": lambda pkg: pkg.codesign({}),
}


def ir_of(pkg):
    return rir if pkg is RC else pir


def opt_of(pkg):
    return ropt if pkg is RC else popt


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_compile_errors_match_reference(case):
    messages = []
    for pkg in (RC, PC):
        with pytest.raises(pkg.CompileError) as err:
            ERRORS[case](pkg)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_entry_points_default_to_the_card(monkeypatch):
    """``run``/``verify`` with no ``device`` run on the card and raise
    where there is none; nothing falls back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k = PC.compile_kernel(lambda a: a + 1, dict(a=16))
    ins = k.random_inputs(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k.verify(ins, GGPUConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k.run(ins, GGPUConfig())
    k.verify(ins, GGPUConfig(), device=CPU)


def test_schedules_and_spaces_equal_reference():
    for rspace, pspace in ((RC.DEFAULT_SPACE, PC.DEFAULT_SPACE),
                           (RC.SMOKE_SPACE, PC.SMOKE_SPACE)):
        assert dataclasses.asdict(pspace) == dataclasses.asdict(rspace)
        for n in (1, 2, 3, 4, 8, 12):
            assert [s.label() for s in pspace.candidates(n)] == \
                [s.label() for s in rspace.candidates(n)]
        assert pspace.size() == rspace.size()
    assert PC.DEFAULT_SCHEDULE.label() == RC.DEFAULT_SCHEDULE.label() == "c1"
    assert sorted(PC.__all__) == sorted(RC.__all__)
