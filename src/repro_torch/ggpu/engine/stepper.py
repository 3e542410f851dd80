"""Stepper: composes the engine stages into the SIMT machine (PyTorch port
of the synchronous part of ``repro.ggpu.engine.stepper``).

The machine is a host loop over lockstep rounds on (B*W, L) tensors. Each
round is a fixed sequence of device operations with no host
synchronisation: the PE execute stage is the CUDA kernel
``repro_torch.kernels.pe_simd.pe_execute`` on the card (its plain version
on the CPU), every other stage plain PyTorch. The host checks termination
once per ``cfg.fuse`` rounds. A round after an element halts (or reaches
``max_steps``) is an exact no-op for that element — its lanes are masked
out of ``active``, so cycles, stats and steps are those of the reference,
which checks after every fused group too.

The reference takes a cheaper branch for rounds without loads or stores
(``lax.cond``); here the memory stage runs every round, which is exact: a
round with no LW/SW has all-false masks, so memory, tags and stats stay
as they were and the round adds no memory cycles.

The core simulates a **cohort** of ``B`` independent machines folded into
the wavefront axis (element e owns wavefronts [e*W, (e+1)*W) and memory
words [e*M, (e+1)*M)), with cycles/stats/steps per element:

  * ``run_kernel``        — one launch (B == 1).
  * ``run_kernel_cohort`` — B launches of one kernel over different memory
    images, exactly B machines. (The reference pads B to a power of two to
    bound its compiled shapes; eager PyTorch compiles nothing, so padding
    would only add work.)
  * ``run_kernel_batch``  — B heterogeneous launches folded the same way:
    each element has its own HALT-padded program rows, item count and
    memory size; the address clip binds at each launch's own size, so the
    zero padding of its memory region is never read or written. (The
    reference ``vmap``s a one-launch core instead; results are the same.)

One write sink (the last memory word) serves every element; it is never
observable. Not ported yet: ``legacy=True``, the ``_async`` entry points,
patches, ``out_region`` and ``mesh=`` sharding (ROADMAP.md).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.ggpu import isa
from repro_torch.ggpu.engine import alu, frontend, scheduler
from repro_torch.ggpu.engine.config import GGPUConfig
from repro_torch.ggpu.engine.memsys import get_memsys, load_store
from repro_torch.kernels import pe_simd


class MachineState(NamedTuple):
    pc: torch.Tensor       # (B*W, L) int32
    regs: torch.Tensor     # (B*W, 32, L) int32 (register-major: row reads)
    done: torch.Tensor     # (B*W, L) bool
    mem: torch.Tensor      # (B*M+1,) int32 (last slot = write sink)
    tags: torch.Tensor     # memsys tag state (shape per organization)
    cycles: torch.Tensor   # (B,) int32 (lockstep-round total per element)
    stats: torch.Tensor    # (B, 4) int32: instrs, mem_ops, hits, misses
    step: torch.Tensor     # (B,) int32


class KernelLaunchError(RuntimeError):
    """A launch did not halt within ``cfg.max_steps``. ``index`` is the
    position of the failing launch within the call's own argument list."""

    def __init__(self, message: str, index: int = 0):
        super().__init__(message)
        self.index = index


LEGACY_TODO = ("legacy=True (the seed-faithful reference stepper) is not "
               "ported yet: ROADMAP.md, queue 1, item 4")


def _n_wavefronts(n_items: int, cfg: GGPUConfig) -> int:
    L = cfg.wavefront
    W = (n_items + L - 1) // L
    # the per-CU residency ranking reshapes (W,) -> (W/n_cus, n_cus); round
    # W up with always-done wavefronts when it would be ragged (state of an
    # invalid wavefront never changes, so this is result/cycle-neutral)
    if W > cfg.n_cus * cfg.max_wf_per_cu and W % cfg.n_cus:
        W += cfg.n_cus - W % cfg.n_cus
    return W


def _static_ops(prog: np.ndarray):
    return tuple(sorted({int(o) for o in prog[:, 0]}))


def run_machine(cfg: GGPUConfig, progs: torch.Tensor, mem_sink: torch.Tensor,
                n_items: Sequence[int], msizes: Sequence[int], W: int,
                ops) -> MachineState:
    """Run ``B = len(n_items)`` folded machines to completion.

    ``progs`` (Bp, P, 5) int32 with Bp == 1 (one program for every
    element) or Bp == B; ``mem_sink`` the (B*M + 1,) concatenated memory
    envelopes plus the write sink, updated in place; ``n_items`` and
    ``msizes`` each element's item count and own memory size (<= M);
    ``ops`` the static opcode set (None = unpruned). Returns the final
    state; the host synchronises once per ``cfg.fuse`` rounds."""
    dev = mem_sink.device
    B = len(n_items)
    Bp, P, _ = progs.shape
    M = (mem_sink.shape[0] - 1) // B
    L = cfg.wavefront
    n_cus = cfg.n_cus
    memsys = get_memsys(cfg.memsys)
    ops_present = None if ops is None else frozenset(ops)
    has_mem = ops_present is None or bool({isa.LW, isa.SW} & ops_present)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    elem_of_w = torch.arange(B, dtype=torch.int32,
                             device=dev).repeat_interleave(W)   # (B*W,)
    cu_of_w = (torch.arange(W, dtype=torch.int32, device=dev)
               % n_cus).repeat(B)
    gid = (torch.arange(W, dtype=torch.int32, device=dev)[:, None] * L
           + torch.arange(L, dtype=torch.int32, device=dev)[None, :]
           ).repeat(B, 1)                                       # elem-local
    n_items_w = i32(n_items)[elem_of_w.long()][:, None]         # (B*W, 1)
    msize_w = i32(msizes)[elem_of_w.long()][:, None]
    mem_off = elem_of_w[:, None] * M
    sink = B * M
    prog_flat = progs.reshape(Bp * P, 5)
    prog_base = elem_of_w * P if Bp > 1 else 0
    is_branch = torch.as_tensor(isa.IS_BRANCH, device=dev)
    extra = i32(isa.SCALAR_EXTRA if cfg.pes_per_cu == 1 else isa.GPU_EXTRA)
    zeros_e = torch.zeros(B, dtype=torch.int32, device=dev)

    def per_elem_sum(x):
        return x.reshape(B, -1).sum(dim=1, dtype=torch.int32)

    st = MachineState(
        pc=torch.zeros((B * W, L), dtype=torch.int32, device=dev),
        regs=torch.zeros((B * W, isa.N_REGS, L), dtype=torch.int32,
                         device=dev),
        done=gid >= n_items_w,
        mem=mem_sink,
        tags=memsys.init_tags(cfg, B, device=dev),
        cycles=zeros_e.clone(),
        stats=torch.zeros((B, 4), dtype=torch.int32, device=dev),
        step=zeros_e.clone(),
    )

    def round_step(s: MachineState) -> MachineState:
        runvec = ~s.done.view(B, -1).all(dim=1) \
            & (s.step < cfg.max_steps)                          # (B,)
        active, _ = scheduler.select_resident(
            s.done, n_cus=n_cus, max_wf_per_cu=cfg.max_wf_per_cu,
            n_elems=B)
        active = active & runvec.repeat_interleave(W)[:, None]
        f = frontend.fetch_decode(prog_flat, P, s.pc, active, s.regs,
                                  prog_base)
        res = pe_simd.pe_execute(f.op, f.imm, f.a, f.b, ops_present)
        res = frontend.apply_intrinsics(res, f.op, gid, n_items_w, L,
                                        ops_present)
        mem, tags = s.mem, s.tags
        hit_service = fill = n_mem = n_hit = n_miss = zeros_e
        if has_mem:
            addr_local = torch.minimum((f.a + f.imm).clamp_min(0),
                                       msize_w - 1)
            is_load = f.op == isa.LW
            mem, loaded, mem_mask = load_store(
                mem, addr_local + mem_off, f.b, f.exec_m, is_load,
                f.op == isa.SW, sink)
            res = torch.where(is_load, loaded, res)
            cr = memsys.access(tags, addr_local, mem_mask, cu_of_w=cu_of_w,
                               elem_of_w=elem_of_w, n_elems=B, cfg=cfg)
            tags, hit_service, fill = cr.tags, cr.hit_service, cr.fill_cycles
            n_mem = per_elem_sum(mem_mask)
            n_hit = per_elem_sum(cr.hit)
            n_miss = per_elem_sum(cr.miss)
        regs = frontend.writeback(s.regs, f, res, is_branch)
        taken = alu.branch_taken(f.op, f.a, f.b, ops_present) & f.exec_m
        pc, done = frontend.advance(s.pc, s.done, f, taken)
        pipe_stall = None
        if cfg.pipeline_depth > 0:
            # each planner-inserted stage adds one dependency bubble per
            # issuing wavefront and one refill cycle per taken branch
            pipe_stall = cfg.pipeline_depth * (
                f.exec_m.any(dim=1).to(torch.int32)
                + taken.any(dim=1).to(torch.int32))
        round_t, wf_exec = scheduler.round_cost(
            f.op[:, 0], f.exec_m, extra=extra,
            issue_cycles=cfg.issue_cycles, cu_of_w=cu_of_w, n_cus=n_cus,
            n_elems=B, hit_service=hit_service, fill_cycles=fill,
            pipe_stall=pipe_stall)
        stats = s.stats + torch.stack(
            [per_elem_sum(wf_exec), n_mem, n_hit, n_miss], dim=1)
        return MachineState(pc, regs, done, mem, tags, s.cycles + round_t,
                            stats, s.step + runvec.to(torch.int32))

    def still_running(s: MachineState) -> bool:
        running = ~s.done.view(B, -1).all(dim=1) & (s.step < cfg.max_steps)
        return bool(running.any())            # the one host sync per group

    fuse = max(1, cfg.fuse)
    while True:
        for _ in range(fuse):
            st = round_step(st)
        if not still_running(st):
            return st


def _info(cycles: int, stats, steps: int, cfg: GGPUConfig) -> dict:
    return {
        "cycles": cycles,
        "instrs": int(stats[0]),
        "mem_ops": int(stats[1]),
        "hits": int(stats[2]),
        "misses": int(stats[3]),
        "steps": steps,
        "time_us": float(cycles / cfg.freq_mhz),
        "memsys": cfg.memsys,
    }


def _results(final: MachineState, cfg: GGPUConfig, B: int, M: int,
             sizes: Sequence[int], what, folded: bool = True
             ) -> List[Tuple[np.ndarray, dict]]:
    """Per-launch (mem, info) of the first ``B`` elements (``folded``:
    info also holds ``batch_size``, as the reference's cohort and batch
    results do); raises ``KernelLaunchError`` naming the first launch that
    did not halt."""
    done = final.done.view(final.cycles.shape[0], -1).all(dim=1).cpu()
    cycles = final.cycles.cpu().numpy()
    stats = final.stats.cpu().numpy()
    steps = final.step.cpu().numpy()
    for i in range(B):
        if not bool(done[i]):
            raise KernelLaunchError(f"{what(i)} hit max_steps without "
                                    "halting", i)
    mem = final.mem[:-1].view(-1, M).cpu().numpy()
    out = []
    for i in range(B):
        info = _info(int(cycles[i]), stats[i], int(steps[i]), cfg)
        if folded:
            info["batch_size"] = B
        out.append((mem[i, :sizes[i]], info))
    return out


def _stage(mems: Sequence[np.ndarray], device) -> torch.Tensor:
    """One fresh device buffer: the images plus the write-sink slot."""
    flat = np.concatenate(list(mems) + [np.zeros(1, np.int32)])
    return torch.from_numpy(flat).to(device)


def run_kernel(prog: np.ndarray, mem0: np.ndarray, n_items: int,
               cfg: GGPUConfig, *, legacy: bool = False, device=None):
    """Execute a kernel. Returns (mem_final, info dict). Runs on the card
    unless ``device`` names another (``"cpu"``: the plain path)."""
    if legacy:
        raise NotImplementedError(LEGACY_TODO)
    dev = _device.resolve(device)
    prog = np.asarray(prog, np.int32)
    mem0 = np.asarray(mem0, np.int32)
    final = run_machine(cfg, torch.from_numpy(prog[None]).to(dev),
                        _stage([mem0], dev), [int(n_items)],
                        [mem0.shape[0]], _n_wavefronts(int(n_items), cfg),
                        _static_ops(prog))
    return _results(final, cfg, 1, mem0.shape[0], [mem0.shape[0]],
                    lambda i: "kernel", folded=False)[0]


def run_kernel_cohort(prog: np.ndarray, mems: Sequence[np.ndarray],
                      n_items: int, cfg: GGPUConfig, *, device=None
                      ) -> List[Tuple[np.ndarray, dict]]:
    """Execute the same kernel over B memory images as one folded machine
    (B*W wavefronts, per-element accounting). Bit-exact per launch."""
    mems = [np.asarray(m, np.int32) for m in mems]
    if not mems:
        return []
    dev = _device.resolve(device)
    msize = mems[0].shape[0]
    if any(m.shape[0] != msize for m in mems):
        raise ValueError("cohort memory images must share one shape")
    prog = np.asarray(prog, np.int32)
    B = len(mems)
    final = run_machine(cfg, torch.from_numpy(prog[None]).to(dev),
                        _stage(mems, dev), [int(n_items)] * B, [msize] * B,
                        _n_wavefronts(int(n_items), cfg), _static_ops(prog))
    return _results(final, cfg, B, msize, [msize] * B,
                    lambda i: f"cohort kernel {i}")


def run_kernel_batch(progs: Sequence[np.ndarray],
                     mems: Sequence[np.ndarray],
                     n_items: Sequence[int], cfg: GGPUConfig, *,
                     device=None) -> List[Tuple[np.ndarray, dict]]:
    """Execute N heterogeneous kernel launches as one folded machine.

    Programs are padded to a common length with HALT words and memory
    images zero-padded to a common size; per-launch results and cycle
    counts are exact (each launch's address clip binds at its own memory
    size). Returns a list of (mem_final, info) in submission order."""
    progs = [np.asarray(p, np.int32) for p in progs]
    mems = [np.asarray(m, np.int32) for m in mems]
    n_items = [int(n) for n in n_items]
    if not (len(progs) == len(mems) == len(n_items)):
        raise ValueError("progs, mems, n_items must have equal length")
    if not progs:
        return []
    dev = _device.resolve(device)
    P = max(p.shape[0] for p in progs)
    M = max(m.shape[0] for m in mems)
    prog_b = np.stack([np.pad(p, ((0, P - p.shape[0]), (0, 0)))
                       for p in progs])                  # HALT == all-zeros
    sizes = [m.shape[0] for m in mems]
    W = max(_n_wavefronts(n, cfg) for n in n_items)
    ops = tuple(sorted(set().union(*(_static_ops(p) for p in progs))))
    final = run_machine(cfg, torch.from_numpy(prog_b).to(dev),
                        _stage([np.pad(m, (0, M - m.shape[0])) for m in mems],
                               dev), n_items, sizes, W, ops)
    return _results(final, cfg, len(progs), M, sizes,
                    lambda i: f"batched kernel {i}")
