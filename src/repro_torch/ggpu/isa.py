"""FGPU-like ISA for the G-GPU SIMT machine (the port's own copy of
``repro.ggpu.isa``: same opcodes, tables and assembler).

A compact MIPS-flavoured RISC ISA, matching FGPU's shape: 32 registers per
work-item, global-memory loads/stores through the central data cache, and
SIMT intrinsics (thread id / item count) in place of FGPU's OpenCL runtime
registers. Instructions are stored unpacked as an int32 ``(P, 5)`` matrix
``[op, rd, rs, rt, imm]`` — simulator-friendly; bit-packing is a hardware
concern the cycle model does not need.

Branch targets are absolute instruction indices (resolved by the assembler
from labels).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# --- opcodes ---------------------------------------------------------------
HALT = 0
ADD, SUB, MUL, MULH, DIV, REM = 1, 2, 3, 4, 5, 6
AND, OR, XOR, SLL, SRL, SRA, SLT = 7, 8, 9, 10, 11, 12, 13
ADDI, ANDI, ORI, XORI, SLLI, SRLI, SRAI, SLTI, LUI = 14, 15, 16, 17, 18, 19, 20, 21, 22
LW, SW = 23, 24
BEQ, BNE, BLT, BGE = 25, 26, 27, 28
TID, NITEMS, WGID = 29, 30, 31

N_OPS = 32
N_REGS = 32

OP_NAMES = {
    v: k for k, v in dict(
        HALT=HALT, ADD=ADD, SUB=SUB, MUL=MUL, MULH=MULH, DIV=DIV, REM=REM,
        AND=AND, OR=OR, XOR=XOR, SLL=SLL, SRL=SRL, SRA=SRA, SLT=SLT,
        ADDI=ADDI, ANDI=ANDI, ORI=ORI, XORI=XORI, SLLI=SLLI, SRLI=SRLI,
        SRAI=SRAI, SLTI=SLTI, LUI=LUI, LW=LW, SW=SW, BEQ=BEQ, BNE=BNE,
        BLT=BLT, BGE=BGE, TID=TID, NITEMS=NITEMS, WGID=WGID).items()
}

IS_BRANCH = np.zeros(N_OPS, bool)
IS_BRANCH[[BEQ, BNE, BLT, BGE]] = True
IS_MEM = np.zeros(N_OPS, bool)
IS_MEM[[LW, SW]] = True
# extra (non-pipelined) cycles per op on the scalar baseline
SCALAR_EXTRA = np.zeros(N_OPS, np.int32)
SCALAR_EXTRA[[MUL, MULH]] = 3
SCALAR_EXTRA[[DIV, REM]] = 8       # CV32E40P-class hardware divider
# extra PE cycles on the G-GPU: deep pipeline hides MUL; FGPU has no native
# divider (soft-divide microkernel, ~50 cycles/item -> 8 lanes x 50 per
# 8-item issue group = 400 per wavefront instruction)
GPU_EXTRA = np.zeros(N_OPS, np.int32)
GPU_EXTRA[[DIV, REM]] = 400


@dataclass
class Assembler:
    """Tiny builder-style assembler with labels.

    >>> a = Assembler()
    >>> a.tid(1); a.lw(2, 1, base); a.addi(2, 2, 5); a.sw(2, 1, base); a.halt()
    """
    instrs: List[Tuple[int, int, int, int, int]] = field(default_factory=list)
    labels: Dict[str, int] = field(default_factory=dict)
    fixups: List[Tuple[int, str]] = field(default_factory=list)

    def _emit(self, op, rd=0, rs=0, rt=0, imm=0):
        self.instrs.append([op, rd, rs, rt, imm])
        return self

    def label(self, name: str):
        self.labels[name] = len(self.instrs)
        return self

    def _branch(self, op, rs, rt, target: str):
        self.fixups.append((len(self.instrs), target))
        return self._emit(op, 0, rs, rt, 0)

    # --- mnemonics ---
    def halt(self): return self._emit(HALT)
    def add(self, rd, rs, rt): return self._emit(ADD, rd, rs, rt)
    def sub(self, rd, rs, rt): return self._emit(SUB, rd, rs, rt)
    def mul(self, rd, rs, rt): return self._emit(MUL, rd, rs, rt)
    def mulh(self, rd, rs, rt): return self._emit(MULH, rd, rs, rt)
    def div(self, rd, rs, rt): return self._emit(DIV, rd, rs, rt)
    def rem(self, rd, rs, rt): return self._emit(REM, rd, rs, rt)
    def and_(self, rd, rs, rt): return self._emit(AND, rd, rs, rt)
    def or_(self, rd, rs, rt): return self._emit(OR, rd, rs, rt)
    def xor(self, rd, rs, rt): return self._emit(XOR, rd, rs, rt)
    def sll(self, rd, rs, rt): return self._emit(SLL, rd, rs, rt)
    def srl(self, rd, rs, rt): return self._emit(SRL, rd, rs, rt)
    def sra(self, rd, rs, rt): return self._emit(SRA, rd, rs, rt)
    def slt(self, rd, rs, rt): return self._emit(SLT, rd, rs, rt)
    def addi(self, rd, rs, imm): return self._emit(ADDI, rd, rs, 0, imm)
    def andi(self, rd, rs, imm): return self._emit(ANDI, rd, rs, 0, imm)
    def ori(self, rd, rs, imm): return self._emit(ORI, rd, rs, 0, imm)
    def xori(self, rd, rs, imm): return self._emit(XORI, rd, rs, 0, imm)
    def slli(self, rd, rs, imm): return self._emit(SLLI, rd, rs, 0, imm)
    def srli(self, rd, rs, imm): return self._emit(SRLI, rd, rs, 0, imm)
    def srai(self, rd, rs, imm): return self._emit(SRAI, rd, rs, 0, imm)
    def slti(self, rd, rs, imm): return self._emit(SLTI, rd, rs, 0, imm)
    def lui(self, rd, imm): return self._emit(LUI, rd, 0, 0, imm)
    def li(self, rd, imm):
        """Load (possibly large) immediate."""
        if -2048 <= imm < 2048:
            return self.addi(rd, 0, imm)
        self.lui(rd, imm >> 12)
        return self.ori(rd, rd, imm & 0xFFF)
    def mv(self, rd, rs): return self.addi(rd, rs, 0)
    def lw(self, rd, rs, imm=0): return self._emit(LW, rd, rs, 0, imm)
    def sw(self, rt, rs, imm=0): return self._emit(SW, 0, rs, rt, imm)
    def beq(self, rs, rt, tgt): return self._branch(BEQ, rs, rt, tgt)
    def bne(self, rs, rt, tgt): return self._branch(BNE, rs, rt, tgt)
    def blt(self, rs, rt, tgt): return self._branch(BLT, rs, rt, tgt)
    def bge(self, rs, rt, tgt): return self._branch(BGE, rs, rt, tgt)
    def tid(self, rd): return self._emit(TID, rd)
    def nitems(self, rd): return self._emit(NITEMS, rd)
    def wgid(self, rd): return self._emit(WGID, rd)

    def assemble(self) -> np.ndarray:
        prog = np.array(self.instrs, np.int32).reshape(-1, 5)
        for idx, name in self.fixups:
            if name not in self.labels:
                raise KeyError(f"undefined label {name!r}")
            prog[idx, 4] = self.labels[name]
        return prog
