"""Stepper: composes the engine stages into the SIMT machine (PyTorch port
of ``repro.ggpu.engine.stepper``).

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
    images, exactly B machines. (The reference pads B to a power of two,
    ``cohort_rows``, to bound its compiled shapes; eager PyTorch compiles
    nothing, so padding would only add work.)
  * ``run_kernel_batch``  — B heterogeneous launches folded the same way:
    each element has its own HALT-padded program rows, item count and
    memory size; the address clip binds at each launch's own size, so the
    zero padding of its memory region is never read or written. (The
    reference ``vmap``s a one-launch core instead; results are the same.)

Each has an ``_async`` twin returning a ``LaunchHandle``; the sync entry
point is ``..._async(...).results()``, so both share one path. Dispatch
is **not overlapped** with the host here: the round loop is driven by the
host, which checks termination once per ``fuse`` rounds, so a dispatch
returns only after its launch has retired. The handle records a CUDA
event (``ready()`` queries it) and downloads memory lazily: only the
declared ``out_region`` slice, nothing for ``(0, 0)``.

**Patches** (device-resident chaining): before the machine runs, regions
of the freshly staged buffer are overwritten (``copy_``) or XORed
(``bitwise_xor_``) with device tensors, in list order, so later patches
win — typically another launch's ``device_mem``/``device_mem_block``,
which are views of that launch's final memory. Patches only read their
sources: a producer's memory is never written through such a view. The
reference donates the staged buffer to XLA; here the machine updates it
in place, so a handle's final memory *is* the staged buffer
(``LaunchHandle.staged``).

One write sink (the last memory word) serves every element; it is never
observable.

**Sharded execution.** The cohort and batch entry points accept a
``mesh=`` (``repro_torch.launch.mesh.LaunchMesh``): the launch axis is
split into one slice per mesh entry, each slice a folded machine of its
own on that entry's device, with its own write sink. A cohort pads ``B``
up to ``cohort_rows(B, shards)`` with copies of its first image, a batch
pads with 1-item HALT fillers up to a multiple of the shard count; every
resolution path drops the padding before it can be observed. There are
no collectives: one host loop issues every still-running shard's
``fuse`` rounds before it reads any shard's termination flag (one read
per device), and stops stepping a shard once its own launches halt.
Steps and cycles count per element, so the bits are the unsharded run's.
A mesh of extent 1, or ``B == 1``, takes the unsharded path on the mesh's
first device. Each shard runs on its device's current stream, so a mesh
that repeats one device runs its shards one after the other there.

**The legacy stepper.** ``run_kernel(legacy=True)`` is the seed-faithful
configuration of the reference's pre-knob engine: one round per host
check (fuse 1) over the unpruned datapath (every opcode). Its stages are
the fused round's, whose results equal the reference's legacy stages
(``tests/test_torch_legacy.py``), so it equals the fused engine in every
observable. Like the reference's, it refuses what the seed model did not
have: a memsys other than ``shared``, ``pipeline_depth > 0``, and ``W``
that does not divide into CU columns (the reference's legacy ranking
predates ragged-W rounding).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.ggpu import isa
from repro_torch.ggpu.engine import alu, frontend, scheduler
from repro_torch.ggpu.engine.config import GGPUConfig
from repro_torch.ggpu.engine.memsys import (SharedCache, get_memsys,
                                            load_store)
from repro_torch.kernels import pe_simd
from repro_torch.launch.mesh import LaunchMesh


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


def _machine(cfg: GGPUConfig, progs: torch.Tensor, mem_sink: torch.Tensor,
             n_items: Sequence[int], msizes: Sequence[int], W: int, ops):
    """One folded machine of ``B = len(n_items)`` elements: returns
    ``(initial state, round_step, running)``, where ``running(state)`` is
    a 0-dim device bool (no host sync).

    ``progs`` (Bp, P, 5) int32 with Bp == 1 (one program for every
    element) or Bp == B; ``mem_sink`` the (B*M + 1,) concatenated memory
    envelopes plus the write sink, updated in place; ``n_items`` and
    ``msizes`` each element's item count and own memory size (<= M);
    ``ops`` the static opcode set (None = unpruned)."""
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

    def running(s: MachineState) -> torch.Tensor:
        return (~s.done.view(B, -1).all(dim=1)
                & (s.step < cfg.max_steps)).any()

    return st, round_step, running


def run_machines(cfg: GGPUConfig, jobs: Sequence[tuple]
                 ) -> List[MachineState]:
    """Run independent folded machines (one per shard) to completion from
    one host loop. ``jobs`` holds ``_machine``'s arguments after ``cfg``
    for each. Every still-running machine's ``fuse`` rounds are
    issued before any termination flag is read, the flags are read once
    per device, and a machine whose own launches halted is not stepped
    again. Returns each machine's final state."""
    machines = [_machine(cfg, *job) for job in jobs]
    states = [m[0] for m in machines]
    fuse = max(1, cfg.fuse)
    live = list(range(len(machines)))
    while live:
        for k in live:
            step = machines[k][1]
            for _ in range(fuse):
                states[k] = step(states[k])
        flags: dict = {}                       # device -> [(k, flag)]
        for k in live:
            flag = machines[k][2](states[k])
            flags.setdefault(flag.device, []).append((k, flag))
        still = set()
        for pairs in flags.values():         # the host syncs: one a device
            read = torch.stack([f for _, f in pairs]).tolist()
            still.update(k for (k, _), r in zip(pairs, read) if r)
        live = [k for k in live if k in still]
    return states


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


def launch_shards(mesh) -> int:
    """How many ways the launch axis splits over ``mesh`` (a
    ``LaunchMesh``): its extent, 1 for ``None``."""
    if mesh is None:
        return 1
    if not isinstance(mesh, LaunchMesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.LaunchMesh,"
                        f" got {type(mesh).__name__}")
    return mesh.size


def cohort_rows(B: int, shards: int = 1) -> int:
    """Padded cohort size for a ``B``-launch cohort over ``shards``
    devices: the per-shard slice rounded up to a power of two. A sharded
    cohort stages this many rows (copies of its first image pad it);
    the unsharded port runs exactly ``B`` machines, since eager PyTorch
    compiles no shape. Executors key their envelope cache on this bucket,
    as the reference does, so their hit/miss counters equal its."""
    b_local = -(-B // shards)
    return shards * (1 << max(0, b_local - 1).bit_length())


def _placement(mesh, device) -> torch.device:
    """The device of an unsharded launch: ``device`` when given, else the
    mesh's first entry, else the card."""
    if device is None and mesh is not None:
        return mesh.devices[0]
    return _device.resolve(device)


Region = Optional[Tuple[int, int]]


# -- device-resident chaining (patches) --------------------------------------
#
# A patch overwrites (or XORs) a region of a launch's staged memory with a
# device tensor before the machine runs. Forms, as in the reference:
#
#   * per-launch: one entry per launch, each None or a list of
#     (dst_lo, dst_hi, src) tuples; an optional fourth element "xor" flips
#     bits instead of overwriting ("set" overwrites);
#   * BlockPatch(lo, hi, block): block row j overwrites launch j's words
#     [lo, hi) — one device op for the whole chunk;
#   * XorBlockPatch(lo, hi, block): the same shape, XORed in (a zero row
#     leaves its launch untouched).


class BlockPatch(NamedTuple):
    """One uniform staged-memory patch across all ``B`` launches of a
    chunk: ``block`` is ``(B, hi - lo)``; row ``j`` overwrites launch
    ``j``'s words ``[lo, hi)``."""
    lo: int
    hi: int
    block: torch.Tensor


class XorBlockPatch(NamedTuple):
    """Like :class:`BlockPatch` but ``block`` row ``j`` is XORed into
    launch ``j``'s words ``[lo, hi)`` (the bit-flip injection form)."""
    lo: int
    hi: int
    block: torch.Tensor


def _check_patches(patches, B: int, sizes: Sequence[int]):
    """Validate patch bounds against each launch's own memory size."""
    if isinstance(patches, (BlockPatch, XorBlockPatch)):
        lo, hi, block = patches
        if not all(0 <= lo <= hi <= s for s in sizes[:B]):
            raise ValueError(f"block patch [{lo}, {hi}) outside a launch's "
                             f"memory image (sizes {list(sizes[:B])})")
        if tuple(block.shape) != (B, hi - lo):
            raise ValueError(f"block patch expects shape {(B, hi - lo)}, "
                             f"got {tuple(block.shape)}")
        return
    patches = list(patches)
    if len(patches) != B:
        raise ValueError(f"patches has {len(patches)} entries for "
                         f"{B} launches")
    for plist, size in zip(patches, sizes):
        for entry in (plist or ()):
            lo, hi, src = entry[0], entry[1], entry[2]
            if len(entry) > 3 and entry[3] not in ("set", "xor"):
                raise ValueError(f"patch op must be 'set' or 'xor', "
                                 f"got {entry[3]!r}")
            if not (0 <= lo <= hi <= size):
                raise ValueError(f"patch [{lo}, {hi}) outside memory "
                                 f"image [0, {size})")
            if tuple(np.shape(src)) != (hi - lo,):
                raise ValueError(f"patch [{lo}, {hi}) expects "
                                 f"{hi - lo} words, got {np.shape(src)}")


def _patch_region(region: torch.Tensor, src, xor: bool) -> None:
    """Write ``src`` into ``region`` (a view of a staged buffer) in place:
    overwrite, or XOR when ``xor``. ``src`` is only read."""
    src = torch.as_tensor(src, dtype=torch.int32, device=region.device)
    if xor:
        region.bitwise_xor_(src)
    else:
        region.copy_(src)


def _patch_rows(body: torch.Tensor, patches) -> None:
    """Apply patches in place to a row-per-launch view ``(rows, msize)`` of
    a staged buffer, in list order (later patches win)."""
    if isinstance(patches, (BlockPatch, XorBlockPatch)):
        lo, hi, block = patches
        _patch_region(body[:block.shape[0], lo:hi], block,
                      isinstance(patches, XorBlockPatch))
        return
    for i, plist in enumerate(patches):
        for entry in (plist or ()):
            _patch_region(body[i, entry[0]:entry[1]], entry[2],
                          len(entry) > 3 and entry[3] == "xor")


def _patch_flat(staged: torch.Tensor, msize: int, patches) -> None:
    """Patch a flat ``(rows*msize + 1,)`` staging buffer in place."""
    rows = (staged.shape[0] - 1) // msize
    _patch_rows(staged[:rows * msize].view(rows, msize), patches)


def _check_regions(regions: Optional[Sequence[Region]], B: int,
                   sizes: Sequence[int]) -> Optional[List[Region]]:
    """Validate per-launch output regions against each launch's own memory
    size. ``None`` (no slicing) stays ``None`` so the full-image download
    path is taken."""
    if regions is None:
        return None
    regions = list(regions)
    if len(regions) != B:
        raise ValueError(f"out_regions has {len(regions)} entries for "
                         f"{B} launches")
    for r, size in zip(regions, sizes):
        if r is None:
            continue
        lo, hi = r
        if not (0 <= lo <= hi <= size):
            raise ValueError(f"out_region {r} outside memory image "
                             f"[0, {size})")
    if all(r is None for r in regions):
        return None
    return regions


def _patch_shard(patches, lo: int, hi: int):
    """The patches of launches ``[lo, hi)`` (one shard's real launches),
    re-indexed from 0; ``None`` when none of them is patched."""
    if hi <= lo:
        return None
    if isinstance(patches, (BlockPatch, XorBlockPatch)):
        return type(patches)(patches.lo, patches.hi, patches.block[lo:hi])
    return list(patches)[lo:hi]


_WHAT = {"single": lambda i: "kernel",
         "cohort": lambda i: f"cohort kernel {i}",
         "shard-cohort": lambda i: f"cohort kernel {i}",
         "batch": lambda i: f"batched kernel {i}"}


class LaunchHandle:
    """One dispatched (possibly folded, possibly sharded) kernel launch.

    The dispatch has already run the machines to completion (module doc);
    ``ready()`` queries the CUDA event recorded after it on each device
    (True on the CPU). ``wait()`` fetches only the small per-launch arrays
    (one transfer per shard) and raises ``KernelLaunchError`` naming the
    first launch that hit ``max_steps``, again on every call. The final
    memory stays on the device until asked for: ``mem(i)`` downloads
    launch ``i``'s declared ``out_region`` slice (``(0, 0)``: nothing), the
    full image otherwise; when every launch declares the same region, one
    slice of the whole chunk is downloaded. ``results()`` returns the sync
    entry point's ``(mem, info)`` pairs.

    Memory layout: one flat tensor per shard, ``b_local`` rows of
    ``msize`` words plus that shard's write sink; launch ``i`` is row
    ``i % b_local`` of shard ``i // b_local``. An unsharded dispatch is
    one shard of ``B`` rows. A batch keeps each launch's own size in
    ``n_keep``. Rows past ``B`` (a sharded dispatch's padding) are never
    observable: not in ``len``, ``infos``, ``mem``, the device views or
    ``KernelLaunchError.index``. ``staged`` is the buffer the dispatch
    staged and patched (a tuple of one per shard when sharded): the
    machines updated it in place, so it holds the final memory — the
    port's analogue of the reference's donated buffer. Kind
    ``"shard-cohort"`` is a sharded cohort.
    """

    def __init__(self, finals: Sequence[MachineState], cfg: GGPUConfig,
                 kind: str, B: int, msize: int,
                 n_keep: Optional[Sequence[int]],
                 regions: Optional[Sequence[Region]],
                 batch_size: Optional[int], staged: Sequence[torch.Tensor]):
        self._finals = list(finals)
        self._cfg = cfg
        self._kind = kind
        self._B = B
        self._msize = msize
        self._b_local = (self._finals[0].mem.shape[0] - 1) // msize
        self._n_keep = list(n_keep) if n_keep is not None else None
        self._regions = regions            # checked by _check_regions
        self._batch_size = batch_size
        self.staged = staged[0] if len(staged) == 1 else tuple(staged)
        self._events = []
        for dev in dict.fromkeys(buf.device for buf in staged):
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                self._events.append(event)
        self._small = None                     # (cycles, stats, steps)
        self._mem_full = None
        self._mems: dict = {}

    def __len__(self) -> int:
        return self._B

    def ready(self) -> bool:
        """Non-blocking: has every device finished this dispatch?"""
        return all(e.query() for e in self._events)

    def wait(self) -> "LaunchHandle":
        """Fetch the small per-launch arrays; raise ``KernelLaunchError``
        naming the first failing launch (never a padding row)."""
        if self._small is not None:
            return self
        parts = []
        for f in self._finals:
            done = f.done.reshape(self._b_local, -1).all(dim=1, keepdim=True)
            parts.append(torch.cat([done.to(torch.int32), f.cycles[:, None],
                                    f.stats, f.step[:, None]],
                                   dim=1).cpu().numpy())
        small = np.concatenate(parts)[:self._B]
        for i in range(self._B):
            if not small[i, 0]:
                raise KernelLaunchError(
                    f"{_WHAT[self._kind](i)} hit max_steps without halting",
                    i)
        self._small = (small[:, 1], small[:, 2:6], small[:, 6])
        return self

    # -- resolution ----------------------------------------------------------

    def info(self, i: int = 0) -> dict:
        cycles, stats, steps = self.wait()._small
        info = _info(int(cycles[i]), stats[i], int(steps[i]), self._cfg)
        if self._batch_size is not None:
            info["batch_size"] = self._batch_size
        return info

    def infos(self) -> List[dict]:
        return [self.info(i) for i in range(self._B)]

    def mem(self, i: int = 0) -> np.ndarray:
        """Launch ``i``'s final memory: the declared region slice when one
        was given, the full image otherwise (downloaded once, cached)."""
        region = self._regions[i] if self._regions is not None else None
        if region is None:
            return self._full_mem(i)
        if i not in self._mems:
            lo, hi = region
            if hi <= lo:
                self._mems[i] = np.zeros(0, np.int32)
            elif all(r == region for r in self._regions):
                block = self.device_mem_block(lo, hi).cpu().numpy()
                for j in range(self._B):
                    self._mems[j] = block[j]
            else:
                self._mems[i] = self.device_mem(i, region).cpu().numpy()
        return self._mems[i]

    def _rows(self, f: MachineState) -> torch.Tensor:
        """One shard's final memory as a ``(b_local, msize)`` view."""
        return f.mem[:self._b_local * self._msize].view(self._b_local,
                                                        self._msize)

    def _full_mem(self, i: int) -> np.ndarray:
        if self._mem_full is None:
            self._mem_full = np.concatenate(
                [self._rows(f).cpu().numpy() for f in self._finals])
        row = self._mem_full[i]
        return row[:self._n_keep[i]] if self._n_keep is not None else row

    # -- device-resident access (no host transfer) ---------------------------

    def device_mem(self, i: int = 0,
                   region: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Launch ``i``'s final-memory ``[lo, hi)`` slice on its shard's
        device (default: the full image): a view of the final memory, for
        feeding a consumer launch's ``patches``. Callers only read it."""
        if not 0 <= i < self._B:
            raise IndexError(f"launch {i} of {self._B}")
        if region is None:
            size = (self._n_keep[i] if self._n_keep is not None
                    else self._msize)
            region = (0, size)
        lo, hi = region
        shard, row = divmod(i, self._b_local)
        base = row * self._msize
        return self._finals[shard].mem[base + lo:base + hi]

    def device_mem_block(self, lo: int, hi: int) -> torch.Tensor:
        """All ``B`` launches' ``[lo, hi)`` slices as one ``(B, hi - lo)``
        tensor, for a consumer chunk's ``BlockPatch``: a view of the final
        memory when unsharded; sharded, the shards' rows gathered on the
        first shard's device (device to device, no host hop)."""
        if len(self._finals) == 1:
            return self._rows(self._finals[0])[:self._B, lo:hi]
        dev = self._finals[0].mem.device
        return torch.cat([self._rows(f)[:, lo:hi].to(dev)
                          for f in self._finals])[:self._B]

    def results(self) -> List[Tuple[np.ndarray, dict]]:
        """All launches as (mem, info) pairs — exactly what the sync entry
        point returns."""
        return [(self.mem(i), self.info(i)) for i in range(self._B)]

    def result(self) -> Tuple[np.ndarray, dict]:
        """Single-launch convenience: the (mem, info) pair."""
        if self._B != 1:
            raise ValueError(f"handle holds {self._B} launches; "
                             "use results()")
        return self.mem(0), self.info(0)


def _stage(mems: Sequence[np.ndarray], device) -> torch.Tensor:
    """One fresh device buffer: the images plus the write-sink slot."""
    flat = np.concatenate(list(mems) + [np.zeros(1, np.int32)])
    return torch.from_numpy(flat).to(device)


def _dispatch(cfg, kind, progs, mems, n_items, sizes, W, ops, devices, *,
              B=None, n_keep=None, regions=None,
              patches=None) -> LaunchHandle:
    """Validate the regions, stage, patch and run the folded machines of
    one dispatch. ``mems`` (equal-size images), ``n_items`` and ``sizes``
    hold every row, padding included, split evenly over ``devices``, one
    machine (shard) per entry; ``progs`` is one program or one per row;
    the first ``B`` rows (default: all) are the caller's launches."""
    rows, msize = len(mems), mems[0].shape[0]
    B = rows if B is None else B
    regions = _check_regions(regions, B, sizes[:B])
    b_local = rows // len(devices)
    jobs, staged = [], []
    for k, dev in enumerate(devices):
        lo, hi = k * b_local, (k + 1) * b_local
        buf = _stage(mems[lo:hi], dev)
        if patches is not None:
            mine = _patch_shard(patches, lo, min(hi, B))
            if mine is not None:
                _patch_flat(buf, msize, mine)
        prog = progs if progs.shape[0] == 1 else progs[lo:hi]
        jobs.append((torch.from_numpy(prog).to(dev), buf, n_items[lo:hi],
                     sizes[lo:hi], W, ops))
        staged.append(buf)
    finals = run_machines(cfg, jobs)
    return LaunchHandle(finals, cfg, kind, B, msize, n_keep, regions,
                        None if kind == "single" else B, staged)


def _check_legacy(cfg: GGPUConfig, W: int) -> None:
    """The legacy stepper's refusals, the reference's: what the seed
    model did not have."""
    if not isinstance(get_memsys(cfg.memsys), SharedCache):
        raise ValueError("legacy reference stepper only models 'shared'")
    if cfg.pipeline_depth:
        raise ValueError("legacy reference stepper predates the "
                         "pipeline_depth knob (seed model: depth 0 only)")
    if W % cfg.n_cus:
        raise ValueError(f"legacy reference stepper ranks W = {W} "
                         f"wavefronts in {cfg.n_cus} CU columns; it predates "
                         "ragged-W rounding and needs W % n_cus == 0")


def run_kernel_async(prog: np.ndarray, mem0: np.ndarray, n_items: int,
                     cfg: GGPUConfig, *, out_region: Region = None,
                     patches=None, legacy: bool = False,
                     device=None) -> LaunchHandle:
    """Dispatch a single launch; returns its ``LaunchHandle``.
    ``out_region=(lo, hi)`` limits the eventual memory download to that
    slice of the final image. ``patches`` optionally overwrites regions of
    the staged memory with device tensors before the run (a flat list of
    ``(lo, hi, src[, "xor"])``, or a block patch of one row). ``legacy``
    runs the seed-faithful reference stepper (module doc). Runs on the
    card unless ``device`` names another (``"cpu"``: the plain path)."""
    dev = _device.resolve(device)
    prog = np.asarray(prog, np.int32)
    mem0 = np.asarray(mem0, np.int32)
    msize = mem0.shape[0]
    W = _n_wavefronts(int(n_items), cfg)
    ops = _static_ops(prog)
    if legacy:
        _check_legacy(cfg, W)
        cfg, ops = dataclasses.replace(cfg, fuse=1), None
    if patches is not None:
        patches = (patches if isinstance(patches, (BlockPatch, XorBlockPatch))
                   else [list(patches)])
        _check_patches(patches, 1, [msize])
    return _dispatch(cfg, "single", prog[None], [mem0], [int(n_items)],
                     [msize], W, ops, [dev],
                     regions=None if out_region is None else [out_region],
                     patches=patches)


def run_kernel(prog: np.ndarray, mem0: np.ndarray, n_items: int,
               cfg: GGPUConfig, *, legacy: bool = False, device=None):
    """Execute a kernel. Returns (mem_final, info dict). ``legacy=True``
    runs the seed-faithful reference stepper (identical results and
    cycles; one host check a round). Runs on the card unless ``device``
    names another (``"cpu"``: the plain path)."""
    return run_kernel_async(prog, mem0, n_items, cfg, legacy=legacy,
                            device=device).result()


def run_kernel_cohort_async(prog: np.ndarray, mems: Sequence[np.ndarray],
                            n_items: int, cfg: GGPUConfig, *,
                            out_regions: Optional[Sequence[Region]] = None,
                            patches=None, mesh=None,
                            device=None) -> LaunchHandle:
    """Dispatch B same-kernel launches as one folded machine.
    ``out_regions`` optionally declares one download slice per launch
    (``None`` entries download that launch's full image). ``patches``: a
    ``BlockPatch``/``XorBlockPatch`` or one ``[(lo, hi, src), ...]`` list
    per launch (see the patch protocol above). ``mesh`` (a
    ``LaunchMesh``) shards the launch axis, one folded machine per entry
    over ``cohort_rows(B, shards)`` rows (module doc); unsharded, the
    launches run on ``device`` (default: the mesh's first entry, else the
    card)."""
    prog = np.asarray(prog, np.int32)
    mems = [np.asarray(m, np.int32) for m in mems]
    if not mems:
        raise ValueError("empty cohort")
    msize = mems[0].shape[0]
    if any(m.shape[0] != msize for m in mems):
        raise ValueError("cohort memory images must share one shape")
    B = len(mems)
    if patches is not None:
        _check_patches(patches, B, [msize] * B)
    shards = launch_shards(mesh)
    kind, devices = "cohort", [_placement(mesh, device)]
    if shards > 1 and B > 1:
        kind, devices = "shard-cohort", list(mesh.devices)
        mems = mems + [mems[0]] * (cohort_rows(B, shards) - B)
    rows = len(mems)
    return _dispatch(cfg, kind, prog[None], mems, [int(n_items)] * rows,
                     [msize] * rows, _n_wavefronts(int(n_items), cfg),
                     _static_ops(prog), devices, B=B, regions=out_regions,
                     patches=patches)


def run_kernel_cohort(prog: np.ndarray, mems: Sequence[np.ndarray],
                      n_items: int, cfg: GGPUConfig, *, mesh=None,
                      device=None) -> List[Tuple[np.ndarray, dict]]:
    """Execute the same kernel over B memory images as one folded machine
    (B*W wavefronts, per-element accounting). Bit-exact per launch."""
    mems = list(mems)                # materialize once: iterators welcome
    if not mems:
        return []
    return run_kernel_cohort_async(prog, mems, n_items, cfg, mesh=mesh,
                                   device=device).results()


def run_kernel_batch_async(progs: Sequence[np.ndarray],
                           mems: Sequence[np.ndarray],
                           n_items: Sequence[int], cfg: GGPUConfig, *,
                           out_regions: Optional[Sequence[Region]] = None,
                           patches=None, mesh=None,
                           device=None) -> LaunchHandle:
    """Dispatch N heterogeneous launches as one folded machine (padding as
    ``run_kernel_batch``). ``out_regions`` and ``patches`` are checked
    against each launch's own memory size, not the padded envelope.
    ``mesh`` shards the launch axis, padding N up to a multiple of the
    shard count with 1-item HALT fillers (module doc); unsharded, the
    launches run on ``device`` (default: the mesh's first entry, else the
    card)."""
    if not (len(progs) == len(mems) == len(n_items)):
        raise ValueError("progs, mems, n_items must have equal length")
    if not progs:
        raise ValueError("empty batch")
    progs = [np.asarray(p, np.int32) for p in progs]
    mems = [np.asarray(m, np.int32) for m in mems]
    n_items = [int(n) for n in n_items]
    B = len(progs)
    if patches is not None:
        _check_patches(patches, B, [m.shape[0] for m in mems])
    shards = launch_shards(mesh)
    devices = [_placement(mesh, device)]
    if shards > 1 and B > 1:
        devices = list(mesh.devices)
        pad = -B % shards
        progs = progs + [np.zeros((1, 5), np.int32)] * pad      # HALT
        mems = mems + [np.zeros(1, np.int32)] * pad
        n_items = n_items + [1] * pad
    sizes = [m.shape[0] for m in mems]
    P = max(p.shape[0] for p in progs)
    M = max(sizes)
    prog_b = np.stack([np.pad(p, ((0, P - p.shape[0]), (0, 0)))
                       for p in progs])                  # HALT == all-zeros
    W = max(_n_wavefronts(n, cfg) for n in n_items)
    ops = tuple(sorted(set().union(*(_static_ops(p) for p in progs))))
    return _dispatch(cfg, "batch", prog_b,
                     [np.pad(m, (0, M - m.shape[0])) for m in mems], n_items,
                     sizes, W, ops, devices, B=B, n_keep=sizes[:B],
                     regions=out_regions, patches=patches)


def run_kernel_batch(progs: Sequence[np.ndarray],
                     mems: Sequence[np.ndarray],
                     n_items: Sequence[int], cfg: GGPUConfig, *, mesh=None,
                     device=None) -> List[Tuple[np.ndarray, dict]]:
    """Execute N heterogeneous kernel launches as one folded machine.

    Programs are padded to a common length with HALT words and memory
    images zero-padded to a common size; per-launch results and cycle
    counts are exact (each launch's address clip binds at its own memory
    size). Returns a list of (mem_final, info) in submission order."""
    progs = list(progs)              # materialize once: iterators welcome
    if not progs:
        return []
    return run_kernel_batch_async(progs, list(mems), list(n_items), cfg,
                                  mesh=mesh, device=device).results()
