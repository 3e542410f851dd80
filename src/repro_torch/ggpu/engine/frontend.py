"""Frontend stage: fetch, decode, operand read, and retire (PyTorch port of
``repro.ggpu.engine.frontend``).

  * **fetch** — every wavefront executes the instruction at the *minimum*
    active PC with the lane mask ``pc == pc_min`` (divergent paths
    serialize; reconvergence is automatic at the min-PC join);
  * **decode/operand read** — per-wavefront register-file gather of the two
    source operands;
  * **retire** — masked register writeback and PC advance (branch targets
    are absolute instruction indices).

All helpers are (W, L)-tensor functions with no host synchronisation, so
the stepper can enqueue rounds back to back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.ggpu import isa


class Fetched(NamedTuple):
    """One decoded instruction per wavefront plus its execution mask."""
    op: torch.Tensor      # (W, 1) int32 opcode (contiguous)
    rd: torch.Tensor      # (W,)  destination register
    rs: torch.Tensor      # (W,)  source register 1
    rt: torch.Tensor      # (W,)  source register 2
    imm: torch.Tensor     # (W, 1) immediate / branch target (contiguous)
    pc_min: torch.Tensor  # (W, 1) the fetched PC
    exec_m: torch.Tensor  # (W, L) bool: lanes executing this round
    a: torch.Tensor       # (W, L) rs operand values
    b: torch.Tensor       # (W, L) rt operand values


def fetch_decode(prog, prog_len: int, pc, active, regs,
                 prog_base=0) -> Fetched:
    """Min-PC fetch + operand gather for every wavefront.

    ``prog`` is (P, 5), or the (B*P, 5) stack of a batch's programs with
    ``prog_base`` (W,) the first row of each wavefront's program.
    ``regs`` is laid out (W, N_REGS, L) — register-major — so the operand
    reads are one L-length row window per wavefront."""
    pc_min = torch.where(active, pc, prog_len).amin(dim=1, keepdim=True)
    row = pc_min[:, 0].clamp(0, prog_len - 1) + prog_base
    instr = prog[row].t().contiguous()                        # (5, W)
    op, rd, rs, rt, imm = instr
    exec_m = active & (pc == pc_min)
    w = torch.arange(regs.shape[0], device=regs.device)
    return Fetched(op[:, None], rd, rs, rt, imm[:, None], pc_min, exec_m,
                   regs[w, rs], regs[w, rt])


def apply_intrinsics(res, op, gid, n_items, wavefront: int,
                     ops_present=None):
    """SIMT intrinsic results (thread id / item count / workgroup id),
    overriding the ALU result where the opcode matches. ``n_items`` is an
    int or a per-wavefront (W, 1) tensor (batches of launches)."""
    if ops_present is None or isa.TID in ops_present:
        res = torch.where(op == isa.TID, gid, res)
    if ops_present is None or isa.NITEMS in ops_present:
        res = torch.where(op == isa.NITEMS, n_items, res)
    if ops_present is None or isa.WGID in ops_present:
        res = torch.where(op == isa.WGID, gid // wavefront, res)
    return res


def writeback(regs, f: Fetched, res, is_branch):
    """Masked register-file writeback (r0 is hardwired zero; branches and
    stores write nothing): one (L,) row window per wavefront, masked lanes
    rewriting their previous value. Each wavefront writes only its own
    row, so the scatter has no duplicate index. Updates ``regs`` in place
    (it saves a copy of the register file per round) and returns it."""
    do_wr = f.exec_m & (f.rd[:, None] != 0) \
        & ~is_branch[f.op[:, 0]][:, None] & (f.op != isa.SW)
    w = torch.arange(regs.shape[0], device=regs.device)
    prev = regs[w, f.rd]
    regs[w, f.rd] = torch.where(do_wr, res, prev)
    return regs


def advance(pc, done, f: Fetched, taken):
    """PC update (fallthrough or absolute branch target) and HALT retire."""
    pc_next = torch.where(taken, f.imm, f.pc_min + 1)
    pc = torch.where(f.exec_m, pc_next, pc)
    done = done | (f.exec_m & (f.op == isa.HALT))
    return pc, done
