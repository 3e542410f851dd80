"""Naive PyTorch oracle for the PE execute stage (the counterpart of
``repro.kernels.ref.pe_alu_ref``).

Written independently of ``engine.alu``: every case is computed exactly in
int64 (where the reference goes through uint32) and wrapped back to int32
once, so a slip in the int32 tricks of the datapath cannot hide behind
shared structure.
"""
from __future__ import annotations

import torch

from repro_torch.ggpu import isa


def _wrap32(x):
    """int64 -> int32 two's-complement wrap, written out."""
    return (((x + 2**31) % 2**32) - 2**31).to(torch.int32)


def pe_alu_ref(op, a, b, imm):
    """Reference G-GPU PE ALU (one opcode per wavefront row).
    op: (W, 1) int32; a, b: (W, L); imm: (W, 1). Mirrors isa semantics."""
    a64, b64, i64 = a.long(), b.long(), imm.long()
    sh = b64.clamp(0, 31)
    shi = i64.clamp(0, 31)
    au = a64 & 0xFFFFFFFF
    b_safe = torch.where(b64 == 0, torch.ones_like(b64), b64)
    zero = torch.zeros_like(a64)
    table = {
        isa.ADD: a64 + b64, isa.SUB: a64 - b64, isa.MUL: a64 * b64,
        isa.MULH: (a64 * b64) >> 32,
        isa.DIV: torch.where(b64 == 0, zero,
                             torch.div(a64, b_safe, rounding_mode="floor")),
        isa.REM: torch.where(b64 == 0, zero, torch.remainder(a64, b_safe)),
        isa.AND: a64 & b64, isa.OR: a64 | b64, isa.XOR: a64 ^ b64,
        isa.SLL: a64 << sh, isa.SRL: au >> sh, isa.SRA: a64 >> sh,
        isa.SLT: (a64 < b64).long(),
        isa.ADDI: a64 + i64, isa.ANDI: a64 & i64, isa.ORI: a64 | i64,
        isa.XORI: a64 ^ i64, isa.SLLI: a64 << shi, isa.SRLI: au >> shi,
        isa.SRAI: a64 >> shi, isa.SLTI: (a64 < i64).long(),
        isa.LUI: (i64 << 12).expand_as(a64),
    }
    out = zero
    for code, val in table.items():
        out = torch.where(op == code, val, out)
    return _wrap32(out)
