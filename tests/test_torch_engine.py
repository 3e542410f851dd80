"""Stage-level parity of the port's engine against the JAX package.

Each stage gets the same seeded state (numpy) on both sides; results must
be equal exactly. Includes the two scatter hazards: two wavefronts storing
to one word in one round, and lanes missing on one cache line with two
different tags (the reference is last-update-wins; the port must resolve
both the same way on any device)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ggpu import isa as jax_isa
from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.ggpu.engine import frontend as jfront
from repro.ggpu.engine import memsys as jmem
from repro.ggpu.engine import scheduler as jsched
from repro_torch.convert import config_from_reference
from repro_torch.ggpu import isa
from repro_torch.ggpu.engine import frontend, memsys, scheduler

W, L, P = 12, 16, 9


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _state(seed):
    g = np.random.default_rng(seed)
    prog = np.stack([g.integers(0, isa.N_OPS, P), g.integers(0, 32, P),
                     g.integers(0, 32, P), g.integers(0, 32, P),
                     g.integers(-4, P + 4, P)], axis=1).astype(np.int32)
    pc = g.integers(0, P + 2, (W, L)).astype(np.int32)
    active = g.random((W, L)) < 0.7
    active[3] = False                              # an all-inactive row
    regs = g.integers(-2**31, 2**31, (W, 32, L)).astype(np.int32)
    return prog, pc, active, regs


def _fetch_both(seed):
    prog, pc, active, regs = _state(seed)
    f_t = frontend.fetch_decode(torch.from_numpy(prog), P,
                                torch.from_numpy(pc),
                                torch.from_numpy(active),
                                torch.from_numpy(regs))
    f_j = jfront.fetch_decode(jnp.asarray(prog), P, jnp.asarray(pc),
                              jnp.asarray(active), jnp.asarray(regs))
    return f_t, f_j, pc, regs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fetch_decode(seed):
    f_t, f_j, _, _ = _fetch_both(seed)
    for field in frontend.Fetched._fields:
        _eq(getattr(f_t, field), getattr(f_j, field))
    assert f_t.op.is_contiguous() and f_t.imm.is_contiguous()


def test_fetch_decode_batched_program_rows():
    """With a stack of programs, each wavefront fetches from its own."""
    progs = [_state(s)[0] for s in (4, 5)]
    _, pc, active, regs = _state(6)
    base = torch.tensor([0] * (W // 2) + [P] * (W // 2), dtype=torch.int32)
    f_t = frontend.fetch_decode(torch.from_numpy(np.concatenate(progs)), P,
                                torch.from_numpy(pc),
                                torch.from_numpy(active),
                                torch.from_numpy(regs), base)
    for half, prog in enumerate(progs):
        rows = slice(half * W // 2, (half + 1) * W // 2)
        f_j = jfront.fetch_decode(jnp.asarray(prog), P, jnp.asarray(pc[rows]),
                                  jnp.asarray(active[rows]),
                                  jnp.asarray(regs[rows]))
        for field in frontend.Fetched._fields:
            _eq(getattr(f_t, field)[rows], getattr(f_j, field))


@pytest.mark.parametrize("seed", [0, 3])
def test_intrinsics_writeback_and_advance(seed):
    f_t, f_j, pc, regs = _fetch_both(seed)
    g = np.random.default_rng(seed + 10)
    res = g.integers(-2**31, 2**31, (W, L)).astype(np.int32)
    gid = (np.arange(W)[:, None] * L + np.arange(L)[None, :]).astype(np.int32)
    for ops in (None, frozenset({isa.TID, isa.WGID})):
        _eq(frontend.apply_intrinsics(torch.from_numpy(res), f_t.op,
                                      torch.from_numpy(gid), 77, L, ops),
            jfront.apply_intrinsics(jnp.asarray(res), f_j.op,
                                    jnp.asarray(gid), 77, L, ops))
    regs_t = frontend.writeback(torch.from_numpy(regs.copy()), f_t,
                                torch.from_numpy(res),
                                torch.from_numpy(isa.IS_BRANCH))
    regs_j = jfront.writeback(jnp.asarray(regs), f_j, jnp.asarray(res),
                              jnp.asarray(jax_isa.IS_BRANCH))
    _eq(regs_t, regs_j)
    taken = g.random((W, L)) < 0.5
    done = g.random((W, L)) < 0.2
    got = frontend.advance(torch.from_numpy(pc), torch.from_numpy(done), f_t,
                           torch.from_numpy(taken))
    want = jfront.advance(jnp.asarray(pc), jnp.asarray(done), f_j,
                          jnp.asarray(taken))
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("n_elems,w_per,n_cus,max_wf", [
    (1, 8, 2, 8),               # static shortcut: every wavefront fits
    (1, 24, 2, 4),              # cumsum ranking
    (3, 16, 4, 2),              # ranking per element of a cohort
    (2, 8, 2, 8),               # static shortcut in a cohort
])
def test_select_resident(n_elems, w_per, n_cus, max_wf):
    """The branch is chosen by shape: ranking only where an element has
    more wavefronts than its CUs can hold."""
    done = np.random.default_rng(w_per).random((n_elems * w_per, 4)) < 0.4
    got = scheduler.select_resident(
        torch.from_numpy(done), n_cus=n_cus, max_wf_per_cu=max_wf,
        n_elems=n_elems)
    want = jsched.select_resident(
        jnp.asarray(done), n_cus=n_cus, max_wf_per_cu=max_wf,
        n_elems=n_elems)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("w_per,depth", [(8, 0), (6, 0), (6, 2), (8, 1)])
def test_round_cost(w_per, depth):
    """Reshape-sum and scatter-add branches, with and without stalls
    (w_per=6 with 4 CUs is ragged and takes the scatter branch by shape)."""
    n_elems, n_cus = 2, 4
    g = np.random.default_rng(w_per + depth)
    Wt = n_elems * w_per
    op_col = g.integers(0, isa.N_OPS, Wt).astype(np.int32)
    exec_m = g.random((Wt, 4)) < 0.5
    cu_of_w = np.tile(np.arange(w_per) % n_cus, n_elems).astype(np.int32)
    hs = g.integers(0, 40, n_elems).astype(np.int32)
    fill = g.integers(0, 40, n_elems).astype(np.int32)
    stall = (g.integers(0, 3, Wt).astype(np.int32) * depth) if depth \
        else None
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
        pipe_stall=None if stall is None else jnp.asarray(stall), **kw)
    for a, b in zip(got, want):
        _eq(a, b)
    assert got[0].dtype == torch.int32


@pytest.mark.parametrize("shape,axis", [((7, 33), -1), ((3, 2, 40), -1),
                                        ((50, 4), 0)])
def test_unique_count(shape, axis):
    g = np.random.default_rng(len(shape))
    vals = g.integers(0, 20, shape).astype(np.int32)
    valid = g.random(shape) < 0.6
    _eq(memsys.unique_count(torch.from_numpy(vals), torch.from_numpy(valid),
                            20, axis),
        jmem.unique_count(jnp.asarray(vals), jnp.asarray(valid), 20, axis))


def _cache_case(seed, n_elems, w_per, cfg):
    g = np.random.default_rng(seed)
    Wt = n_elems * w_per
    addr = g.integers(0, 4096, (Wt, 8)).astype(np.int32)
    mask = g.random((Wt, 8)) < 0.6
    elem_of_w = np.repeat(np.arange(n_elems), w_per).astype(np.int32)
    cu_of_w = np.tile(np.arange(w_per) % cfg.n_cus, n_elems).astype(np.int32)
    return addr, mask, elem_of_w, cu_of_w


def _access_both(name, tags, addr, mask, elem_of_w, cu_of_w, n_elems, cfg):
    got = memsys.get_memsys(name).access(
        torch.from_numpy(tags.copy()), torch.from_numpy(addr),
        torch.from_numpy(mask), cu_of_w=torch.from_numpy(cu_of_w),
        elem_of_w=torch.from_numpy(elem_of_w), n_elems=n_elems,
        cfg=config_from_reference(dataclasses.asdict(cfg)))
    want = jmem.get_memsys(name).access(
        jnp.asarray(tags), jnp.asarray(addr), jnp.asarray(mask),
        cu_of_w=jnp.asarray(cu_of_w), elem_of_w=jnp.asarray(elem_of_w),
        n_elems=n_elems, cfg=cfg)
    for field in memsys.CacheResult._fields:
        _eq(getattr(got, field), getattr(want, field))
    return got


@pytest.mark.parametrize("name", ["shared", "banked", "banked-iso"])
@pytest.mark.parametrize("n_elems", [1, 3])
def test_cache_access(name, n_elems):
    cfg = JaxConfig(n_cus=4, cache_lines=16, line_words=4)
    addr, mask, elem_of_w, cu_of_w = _cache_case(7, n_elems, 8, cfg)
    tags = np.asarray(jmem.get_memsys(name).init_tags(cfg, n_elems))
    for _ in range(3):                   # warm tags through a few rounds
        got = _access_both(name, tags, addr, mask, elem_of_w, cu_of_w,
                           n_elems, cfg)
        tags = got.tags.numpy()
        addr = (addr * 3 + 17) % 4096
        assert int(got.hit.sum()) + int(got.miss.sum()) == int(mask.sum())


@pytest.mark.parametrize("name", ["shared", "banked"])
def test_one_line_missed_with_two_tags(name):
    """Lanes of two wavefronts miss one cache line with two different
    tags in the same round: the highest flat lane index wins the fill."""
    cfg = JaxConfig(n_cus=1, cache_lines=16, line_words=4)
    line_span = cfg.cache_lines * cfg.line_words
    addr = np.zeros((2, 4), np.int32)
    addr[0] = [5, 5 + line_span, 6, 5]               # line 1, tags 1 and 17
    addr[1] = [5 + line_span, 5, 5 + 2 * line_span, 7]
    mask = np.ones((2, 4), bool)
    tags = np.full((1, cfg.cache_lines), -1, np.int32)
    got = _access_both(name, tags, addr, mask, np.zeros(2, np.int32),
                       np.zeros(2, np.int32), 1, cfg)
    assert int(got.tags[0, 1]) == 5 >> 2             # from the last lane


def _load_store_both(mem, addr, val, exec_m, is_load, is_store, sink):
    got = memsys.load_store(*map(torch.from_numpy, (mem.copy(), addr, val,
                                                    exec_m, is_load,
                                                    is_store)), sink)
    want = jmem.load_store(*map(jnp.asarray, (mem, addr, val, exec_m,
                                              is_load, is_store)), sink)
    for a, b in zip(got, want):
        _eq(a, b)
    return got


def test_load_store_random():
    g = np.random.default_rng(3)
    M = 64
    mem = g.integers(-99, 99, M + 1).astype(np.int32)
    addr = g.integers(0, M, (W, L)).astype(np.int32)
    val = g.integers(-2**31, 2**31, (W, L)).astype(np.int32)
    exec_m = g.random((W, L)) < 0.7
    op = g.integers(isa.LW, isa.SW + 1, (W, 1))
    _load_store_both(mem, addr, val, exec_m, op == isa.LW, op == isa.SW, M)


def test_two_wavefronts_store_to_one_word():
    """Two wavefronts (and lanes within one) store to word 3 in the same
    round: the highest flat lane index wins, as in the reference."""
    M = 8
    mem = np.arange(M + 1, dtype=np.int32)
    addr = np.array([[3, 3, 1, 3], [2, 3, 3, 0]], np.int32)
    val = np.array([[10, 11, 12, 13], [20, 21, 22, 23]], np.int32)
    exec_m = np.array([[1, 1, 1, 1], [1, 1, 1, 0]], bool)
    is_store = np.ones((2, 1), bool)
    got = _load_store_both(mem, addr, val, exec_m, ~is_store, is_store, M)
    assert int(got[0][3]) == 22
