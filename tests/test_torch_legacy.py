"""The port's legacy stepper (``run_kernel(legacy=True)``, the
seed-faithful reference round) against the JAX package's, exactly: the
port's stages against the reference's legacy stage options (``force_rank``,
``use_scatter``, ``always_scatter``, ``one_hot``, ``dense``) on seeded
random inputs, which is why the port's legacy stepper runs the fused
round's stages, the refusals, and tests/test_engine.py's xcorr(32, 256)
on 2 CUs. The 8 benches of tests/test_dse.py, each held
to the port's fused run (and on the scalar baseline and 2 CUs to the JAX
package's legacy run), are in test_torch_legacy_{scalar,cu1,cu2,cu4,cu8}.py,
one file a machine to keep every file within a test worker's budget;
they import ``check_legacy`` from here."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parity import configs

from repro.ggpu import isa as jax_isa
from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.ggpu.engine import frontend as jfront
from repro.ggpu.engine import memsys as jmem
from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro.ggpu.engine import scheduler as jsched
from repro_torch.convert import config_from_reference
from repro_torch.ggpu import isa, programs
from repro_torch.ggpu.engine import (GGPUConfig, ScalarConfig, frontend,
                                     memsys, run_kernel, scheduler)

STAT_KEYS = ("cycles", "instrs", "mem_ops", "hits", "misses", "steps")
# tests/test_dse.py's sizes: 512 GPU items, W = 8 wavefronts, which every
# CU count divides (the reference's legacy stepper ranks residency always,
# ragged-W rounding); mat_mul dim 32 -> 1024 items, W = 16
LEGACY_BENCHES = {
    "copy": lambda: programs._copy(32, 512),
    "vec_mul": lambda: programs._vec_mul(32, 512),
    "mat_mul": lambda: programs._mat_mul(4, 32),
    "fir": lambda: programs._fir(32, 512),
    "div_int": lambda: programs._div_int(16, 512),
    "xcorr": lambda: programs._xcorr(16, 512),
    "parallel_sel": lambda: programs._parallel_sel(32, 512),
    "reduction": lambda: programs._reduction(64, 4096, seg=8),
}


def _same(got, want, what):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]), what)
    for k in STAT_KEYS:
        assert got[1][k] == want[1][k], (what, k)


def check_legacy(name: str, machine, with_jax: bool) -> None:
    """Bench ``name`` on ``machine`` ("scalar" or a CU count): the port's
    legacy run equals its fused run and, ``with_jax``, the JAX package's
    legacy run, in memory, cycles, stats and steps."""
    b = LEGACY_BENCHES[name]()
    scalar = machine == "scalar"
    jcfg, cfg = configs(scalar) if scalar else configs(n_cus=machine)
    args = ((b.scalar_prog, b.scalar_mem, 1) if scalar
            else (b.gpu_prog, b.gpu_mem, b.gpu_items))
    legacy = run_kernel(*args, cfg, legacy=True, device="cpu")
    _same(legacy, run_kernel(*args, cfg, device="cpu"),
          f"{name}/{machine}: legacy != fused")
    if with_jax:
        _same(legacy, jax_run_kernel(*args, jcfg, legacy=True),
              f"{name}/{machine}: legacy != the JAX package's legacy")


def test_legacy_xcorr_2cu_equals_reference():
    """tests/test_engine.py's test_legacy_reference_bit_exact case."""
    b = programs._xcorr(32, 256)
    jcfg, cfg = configs(n_cus=2)
    args = (b.gpu_prog, b.gpu_mem, b.gpu_items)
    legacy = run_kernel(*args, cfg, legacy=True, device="cpu")
    _same(legacy, jax_run_kernel(*args, jcfg, legacy=True), "xcorr legacy")
    _same(legacy, run_kernel(*args, cfg, device="cpu"), "xcorr fused")


def test_legacy_refuses_what_the_reference_refuses():
    b = programs._copy(16, 128)
    args = (b.gpu_prog, b.gpu_mem, b.gpu_items)
    for memsys_name in ("banked", "banked-iso"):
        with pytest.raises(ValueError, match="shared"):
            run_kernel(*args, GGPUConfig(memsys=memsys_name), legacy=True,
                       device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth"):
        run_kernel(*args, GGPUConfig(pipeline_depth=1), legacy=True,
                   device="cpu")
    # W = 2 wavefronts in 8 CU columns: the reference's reshape fails too
    with pytest.raises(ValueError, match="W % n_cus"):
        run_kernel(*args, GGPUConfig(n_cus=8), legacy=True, device="cpu")
    # the scalar baseline runs legacy too
    s = run_kernel(b.scalar_prog, b.scalar_mem, 1, ScalarConfig(),
                   legacy=True, device="cpu")
    _same(s, run_kernel(b.scalar_prog, b.scalar_mem, 1, ScalarConfig(),
                        device="cpu"), "scalar copy")


# -- the port's stages, each against the reference's legacy option --------

def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("n_elems,w_per,n_cus,max_wf", [
    (1, 8, 2, 8), (1, 8, 8, 8), (2, 16, 4, 8), (1, 24, 2, 4)])
def test_select_resident_force_rank(n_elems, w_per, n_cus, max_wf):
    """The residency the reference's ``force_rank`` ranks even where every
    wavefront fits is what the port's shortcut returns."""
    done = np.random.default_rng(w_per + n_cus).random(
        (n_elems * w_per, 4)) < 0.4
    kw = dict(n_cus=n_cus, max_wf_per_cu=max_wf, n_elems=n_elems)
    got = scheduler.select_resident(torch.from_numpy(done), **kw)
    want = jsched.select_resident(jnp.asarray(done), force_rank=True, **kw)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("w_per,depth", [(8, 0), (6, 0), (8, 2)])
def test_round_cost_use_scatter(w_per, depth):
    """The reference's ``use_scatter`` sums issue work by scatter-add at
    every shape; the port's reshape-sum gives the same round cost."""
    n_elems, n_cus = 1, 2
    g = np.random.default_rng(w_per * 3 + depth)
    Wt = n_elems * w_per
    op_col = g.integers(0, isa.N_OPS, Wt).astype(np.int32)
    exec_m = g.random((Wt, 4)) < 0.5
    cu_of_w = (np.arange(w_per) % n_cus).astype(np.int32)
    hs = g.integers(0, 40, n_elems).astype(np.int32)
    fill = g.integers(0, 40, n_elems).astype(np.int32)
    stall = g.integers(0, 3, Wt).astype(np.int32) * depth if depth else None
    kw = dict(issue_cycles=8, n_cus=n_cus, n_elems=n_elems)
    got = scheduler.round_cost(
        torch.from_numpy(op_col), torch.from_numpy(exec_m),
        extra=torch.from_numpy(isa.GPU_EXTRA),
        cu_of_w=torch.from_numpy(cu_of_w), hit_service=torch.from_numpy(hs),
        fill_cycles=torch.from_numpy(fill),
        pipe_stall=None if stall is None else torch.from_numpy(stall), **kw)
    want = jsched.round_cost(
        jnp.asarray(op_col), jnp.asarray(exec_m),
        extra=jnp.asarray(jax_isa.GPU_EXTRA), cu_of_w=jnp.asarray(cu_of_w),
        hit_service=jnp.asarray(hs), fill_cycles=jnp.asarray(fill),
        pipe_stall=None if stall is None else jnp.asarray(stall),
        use_scatter=True, **kw)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("always_scatter", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_load_store_always_scatter(always_scatter, seed):
    """The port's store scatter runs every round, so it equals the
    reference's round under either ``always_scatter`` setting."""
    g = np.random.default_rng(seed)
    W, L, M = 12, 16, 64
    mem = g.integers(-99, 99, M + 1).astype(np.int32)
    addr = g.integers(0, M, (W, L)).astype(np.int32)
    val = g.integers(-2**31, 2**31, (W, L)).astype(np.int32)
    exec_m = g.random((W, L)) < 0.7
    op = g.integers(isa.LW, isa.SW + 1, (W, 1))
    got = memsys.load_store(
        torch.from_numpy(mem.copy()), torch.from_numpy(addr),
        torch.from_numpy(val), torch.from_numpy(exec_m),
        torch.from_numpy(op == isa.LW), torch.from_numpy(op == isa.SW), M)
    want = jmem.load_store(
        jnp.asarray(mem), jnp.asarray(addr), jnp.asarray(val),
        jnp.asarray(exec_m), jnp.asarray(op == isa.LW),
        jnp.asarray(op == isa.SW), M, always_scatter=always_scatter)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shared_cache_one_hot(seed):
    """The port's sort-based line counts equal the reference's one-hot
    line tables (``one_hot``) and its default count, round after
    round."""
    jcfg = JaxConfig(n_cus=2, cache_lines=16, line_words=4)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    g = np.random.default_rng(seed)
    Wt = 8
    addr = g.integers(0, 1024, (Wt, 8)).astype(np.int32)
    mask = g.random((Wt, 8)) < 0.6
    elem_of_w = np.zeros(Wt, np.int32)
    cu_of_w = (np.arange(Wt) % 2).astype(np.int32)
    tags = np.asarray(jmem.SharedCache().init_tags(jcfg, 1))
    for _ in range(3):
        got = memsys.SharedCache().access(
            torch.from_numpy(tags.copy()), torch.from_numpy(addr),
            torch.from_numpy(mask), cu_of_w=torch.from_numpy(cu_of_w),
            elem_of_w=torch.from_numpy(elem_of_w), cfg=cfg, n_elems=1)
        for one_hot in (True, False):
            want = jmem.SharedCache().access(
                jnp.asarray(tags), jnp.asarray(addr), jnp.asarray(mask),
                cu_of_w=jnp.asarray(cu_of_w),
                elem_of_w=jnp.asarray(elem_of_w), cfg=jcfg, n_elems=1,
                one_hot=one_hot)
            for field in memsys.CacheResult._fields:
                _eq(getattr(got, field), getattr(want, field))
        tags = got.tags.numpy()
        addr = (addr * 5 + 3) % 1024


@pytest.mark.parametrize("seed", [0, 3])
def test_writeback_dense(seed):
    """The port's row-window writeback writes what the reference's
    full-register-file select (``dense``) writes."""
    g = np.random.default_rng(seed)
    W, L, P = 12, 16, 9
    prog = np.stack([g.integers(0, isa.N_OPS, P), g.integers(0, 32, P),
                     g.integers(0, 32, P), g.integers(0, 32, P),
                     g.integers(-4, P + 4, P)], axis=1).astype(np.int32)
    pc = g.integers(0, P + 2, (W, L)).astype(np.int32)
    active = g.random((W, L)) < 0.7
    regs = g.integers(-2**31, 2**31, (W, 32, L)).astype(np.int32)
    res = g.integers(-2**31, 2**31, (W, L)).astype(np.int32)
    f_t = frontend.fetch_decode(torch.from_numpy(prog), P,
                                torch.from_numpy(pc),
                                torch.from_numpy(active),
                                torch.from_numpy(regs))
    f_j = jfront.fetch_decode(jnp.asarray(prog), P, jnp.asarray(pc),
                              jnp.asarray(active), jnp.asarray(regs))
    want = jfront.writeback(jnp.asarray(regs), f_j, jnp.asarray(res),
                            jnp.asarray(jax_isa.IS_BRANCH), dense=True)
    _eq(frontend.writeback(torch.from_numpy(regs.copy()), f_t,
                           torch.from_numpy(res),
                           torch.from_numpy(isa.IS_BRANCH)), want)
