"""The port's PE datapath against the JAX package, exactly.

Covers ``select_alu`` (with and without ``ops_present``), ``branch_taken``,
``_mulh32``, ``exec_alu``, the oracle ``pe_alu_ref`` and the CPU path of
the ``pe_execute`` wrapper, on all 32 opcodes and the int32 edges. The
reference's Pallas kernel runs in interpret mode, as tests/test_kernels.py
runs it. Tolerance: none (integer code)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.ggpu.engine import alu as jax_alu
from repro.kernels import ref as jax_ref
from repro.kernels.pe_simd import pe_execute as jax_pe_execute
from repro_torch.ggpu import isa
from repro_torch.ggpu.engine import alu
from repro_torch.kernels import pe_simd, ref

EDGES = np.array([-2**31, 2**31 - 1, -2**31 + 1, -1, 0, 1, 2, -2, 31, 32,
                  33, -7, 0xFFFF, 65536, -65536, 2**20, 12345, -99999],
                 np.int64)
PRUNED = frozenset({isa.ADD, isa.MULH, isa.DIV, isa.SRL, isa.SRLI, isa.LUI,
                    isa.BEQ, isa.BGE, isa.LW})


def _edge_case():
    """Every opcode x every edge immediate, over every (a, b) edge pair:
    INT_MIN // -1, b == 0, shifts < 0 / 0 / 31 / > 31, LUI wrap."""
    a, b = np.meshgrid(EDGES, EDGES, indexing="ij")
    a, b = a.reshape(-1), b.reshape(-1)
    op = np.repeat(np.arange(isa.N_OPS), EDGES.size)[:, None]
    imm = np.tile(EDGES, isa.N_OPS)[:, None]
    W = op.shape[0]
    return [x.astype(np.int32) for x in
            (op, imm, np.broadcast_to(a, (W, a.size)),
             np.broadcast_to(b, (W, b.size)))]


def _random_case(w, l, seed):
    g = np.random.default_rng(seed)
    return [g.integers(lo, hi, shape).astype(np.int32) for lo, hi, shape in
            ((0, isa.N_OPS, (w, 1)), (-2**31, 2**31, (w, 1)),
             (-2**31, 2**31, (w, l)), (-2**31, 2**31, (w, l)))]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@functools.partial(jax.jit, static_argnames="ops_present")
def _jax_select_jit(op, a, b, imm, ops_present=None):
    return jax_alu.select_alu(op, a, b, imm, ops_present)


def _jax_select(op, imm, a, b, ops_present=None):
    return np.asarray(_jax_select_jit(*_j(op, a, b, imm),
                                      ops_present=ops_present))


CASES = {"edges": _edge_case(), "random": _random_case(64, 64, 0),
         "scalar": _random_case(1, 1, 1)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ops_present", [None, PRUNED], ids=["all", "pruned"])
def test_select_alu_matches_reference(case, ops_present):
    op, imm, a, b = CASES[case]
    got = alu.select_alu(*_t(op, a, b, imm), ops_present).numpy()
    np.testing.assert_array_equal(got, _jax_select(op, imm, a, b,
                                                   ops_present))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pe_execute_cpu_path_matches_pallas_kernel(case):
    op, imm, a, b = CASES[case]
    before = pe_simd.LAUNCHES
    got = pe_simd.pe_execute(*_t(op, imm, a, b)).numpy()
    assert pe_simd.LAUNCHES == before      # the CPU path launches nothing
    want = np.asarray(jax_pe_execute(*_j(op, imm, a, b), interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracles_agree(case):
    """The port's int64 oracle == the reference oracle == exec_alu."""
    op, imm, a, b = CASES[case]
    got = ref.pe_alu_ref(*_t(op, a, b, imm)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_ref.pe_alu_ref(*_j(op, a, b, imm))))
    np.testing.assert_array_equal(
        alu.exec_alu(*_t(op, a, b, imm)).numpy(), got)


@pytest.mark.parametrize("ops_present", [None, PRUNED], ids=["all", "pruned"])
def test_branch_taken_matches_reference(ops_present):
    op, _, a, b = CASES["edges"]
    got = alu.branch_taken(*_t(op, a, b), ops_present).numpy()
    want = np.asarray(jax_alu.branch_taken(*_j(op, a, b), ops_present))
    np.testing.assert_array_equal(got, want)


def test_int32_semantics_spelled_out():
    """The hazards a PyTorch translation gets wrong by default."""
    def one(code, a, b=0, imm=0):
        t = lambda v: torch.tensor([[v]], dtype=torch.int32)  # noqa: E731
        return int(alu.select_alu(t(code), t(a), t(b), t(imm))[0, 0])
    assert one(isa.SRL, -7, 2) == 1073741822           # logical, not >>
    assert one(isa.SRLI, -8, imm=1) == 2147483644
    assert one(isa.DIV, -2**31, -1) == -2**31          # wraps
    assert one(isa.REM, -2**31, -1) == 0
    assert one(isa.DIV, -7, 2) == -4                   # floor, not trunc
    assert one(isa.REM, -7, 2) == 1
    assert one(isa.DIV, 5, 0) == 0 and one(isa.REM, 5, 0) == 0
    assert one(isa.SLL, 1, 40) == -2**31               # shift clipped to 31
    assert one(isa.SRA, -8, -3) == -8                  # shift clipped to 0
    assert one(isa.LUI, 0, imm=2**20) == 0             # wraps
    for code in (isa.HALT, isa.LW, isa.SW, isa.BEQ, isa.TID, isa.WGID):
        assert one(code, 3, 4, 5) == 0


def test_mulh_vs_bigint():
    """The int32-only MULH decomposition is exact vs python big ints."""
    rng = np.random.default_rng(7)
    a = rng.integers(-2**31, 2**31, 10000).astype(np.int32)
    b = rng.integers(-2**31, 2**31, 10000).astype(np.int32)
    a[:4], b[:4] = [-2**31, -2**31, 2**31 - 1, -1], [-2**31, -1, 2**31 - 1, -1]
    got = alu._mulh32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    exp = ((a.astype(object) * b.astype(object)) >> 32).astype(np.int64)
    np.testing.assert_array_equal(got, exp.astype(np.int32))
    np.testing.assert_array_equal(
        got, np.asarray(jax_alu._mulh32(jnp.asarray(a), jnp.asarray(b))))


def test_pe_execute_checks_its_inputs():
    op, imm, a, b = _t(*CASES["random"])
    with pytest.raises(TypeError):
        pe_simd.pe_execute(op.long(), imm, a, b)
    with pytest.raises(ValueError):
        pe_simd.pe_execute(op, imm, a.t(), b)
    with pytest.raises(ValueError):
        pe_simd.pe_execute(op[:3], imm, a, b)
    assert pe_simd.ops_mask(None) == 0xFFFFFFFF
    assert pe_simd.ops_mask(frozenset({0, 31})) == (1 | 1 << 31)


@given(st.integers(1, 40), st.integers(1, 128), st.integers(0, 99))
@settings(max_examples=15, deadline=None)
def test_select_alu_property_random(w, l, seed):
    op, imm, a, b = _random_case(w, l, seed)
    got = alu.select_alu(*_t(op, a, b, imm)).numpy()
    np.testing.assert_array_equal(got, _jax_select(op, imm, a, b))
    np.testing.assert_array_equal(got, ref.pe_alu_ref(*_t(op, a, b, imm))
                                  .numpy())
