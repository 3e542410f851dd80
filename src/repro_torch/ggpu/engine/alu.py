"""ALU stage: the PE integer datapath in plain PyTorch.

``select_alu`` is the plain version of the CUDA kernel
``repro_torch.kernels.pe_simd.pe_execute``: every lane computes the
candidate results and the per-wavefront opcode selects one. The CPU tests
hold it against ``repro.ggpu.engine.alu.select_alu``; ``chip_smoke.py``
holds the kernel against it on the card.

All arithmetic is int32 with the reference's semantics:

  * ADD/SUB/MUL/SLL wrap (two's complement);
  * SRL/SRLI are logical shifts (PyTorch's int32 ``>>`` is arithmetic, so
    the high bits are masked off);
  * DIV/REM are floor ops, ``x / 0 -> 0``, ``INT_MIN // -1 -> INT_MIN`` and
    ``INT_MIN % -1 -> 0`` (the divisor is swapped for 1 in both corner
    cases, which gives exactly those results without overflow);
  * shift amounts are clipped to [0, 31];
  * every opcode outside the 22-case table gives 0.

``ops_present`` (a container of opcodes, or None for all) prunes the select
tree: a pruned case gives 0, which is result-neutral for a program whose
opcodes all lie in the set.
"""
from __future__ import annotations

import torch

from repro_torch.ggpu import isa

INT_MIN = -2**31
INT_MAX = 2**31 - 1


def _srl(a, sh):
    """Logical right shift of int32 ``a`` by ``sh`` in [0, 31]."""
    mask = torch.bitwise_right_shift(
        torch.full_like(sh, INT_MAX), (sh - 1).clamp_min(0))
    return torch.where(sh == 0, a, (a >> sh) & mask)


def _mulh32(a, b):
    """Signed 32x32 -> high 32 bits with int32 ops only (the reference's
    decomposition a = a_hi*2^16 + a_lo, a_lo unsigned; all partial
    products fit int32)."""
    a_lo = a & 0xFFFF
    a_hi = a >> 16                      # arithmetic
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    t1 = ((a_lo * b_lo) >> 16) & 0xFFFF    # uint32 product >> 16
    t2 = a_hi * b_lo + t1
    t3 = a_lo * b_hi + (t2 & 0xFFFF)
    return a_hi * b_hi + (t2 >> 16) + (t3 >> 16)


def alu_cases(a, b, imm):
    """The (opcode -> thunk) case table. Thunks defer the arithmetic so a
    pruned select tree never materializes the unused candidates."""
    sh = b.clamp(0, 31)
    shi = imm.clamp(0, 31)
    # divisor 1 where b == 0 (result masked to 0) and for INT_MIN / -1
    # (INT_MIN // 1 == INT_MIN and INT_MIN % 1 == 0, the wrapped results)
    b_safe = torch.where((b == 0) | ((a == INT_MIN) & (b == -1)),
                         torch.ones_like(b), b)

    def div():
        q = torch.div(a, b_safe, rounding_mode="floor")
        return torch.where(b == 0, torch.zeros_like(q), q)

    def rem():
        r = torch.remainder(a, b_safe)
        return torch.where(b == 0, torch.zeros_like(r), r)

    return [
        (isa.ADD, lambda: a + b), (isa.SUB, lambda: a - b),
        (isa.MUL, lambda: a * b), (isa.MULH, lambda: _mulh32(a, b)),
        (isa.DIV, div), (isa.REM, rem),
        (isa.AND, lambda: a & b), (isa.OR, lambda: a | b),
        (isa.XOR, lambda: a ^ b),
        (isa.SLL, lambda: a << sh),
        (isa.SRL, lambda: _srl(a, sh)),
        (isa.SRA, lambda: a >> sh),
        (isa.SLT, lambda: (a < b).to(torch.int32)),
        (isa.ADDI, lambda: a + imm), (isa.ANDI, lambda: a & imm),
        (isa.ORI, lambda: a | imm), (isa.XORI, lambda: a ^ imm),
        (isa.SLLI, lambda: a << shi),
        (isa.SRLI, lambda: _srl(a, shi)),
        (isa.SRAI, lambda: a >> shi),
        (isa.SLTI, lambda: (a < imm).to(torch.int32)),
        (isa.LUI, lambda: (imm << 12).expand_as(a)),
    ]


def select_alu(op, a, b, imm, ops_present=None):
    """Vectorized ALU for one instruction per wavefront.

    op, imm: (W, 1) int32; a, b: (W, L) int32 source values. Returns the
    (W, L) result."""
    result = torch.zeros_like(a)
    for code, thunk in alu_cases(a, b, imm):
        if ops_present is None or code in ops_present:
            result = torch.where(op == code, thunk(), result)
    return result


def exec_alu(op, a, b, imm):
    """Back-compat entry point (full, unpruned datapath)."""
    return select_alu(op, a, b, imm)


def branch_taken(op, a, b, ops_present=None):
    """Branch resolution for the four conditional branches."""
    taken = torch.zeros_like(a, dtype=torch.bool)
    for code, cmp in ((isa.BEQ, lambda: a == b), (isa.BNE, lambda: a != b),
                      (isa.BLT, lambda: a < b), (isa.BGE, lambda: a >= b)):
        if ops_present is None or code in ops_present:
            taken = torch.where(op == code, cmp(), taken)
    return taken
