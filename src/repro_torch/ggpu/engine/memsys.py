"""Memory-system stage (PyTorch port of ``repro.ggpu.engine.memsys``).

The functional memory (the flat word array, masked loads/stores through the
write sink) is organization-independent and lives in ``load_store``. A
memory system models the *cycle cost* of a round's coalesced memory
traffic. Every organization keeps per-element tag state for a cohort of
``n_elems`` machines folded into the wavefront axis and returns
per-element cycle terms:

    hit_service  — cycles for hit traffic to stream through the data movers
    fill_cycles  — cycles of DRAM fill bandwidth for missed lines

Two differences from the reference, both result-neutral:

  * No round-dependent control flow: the store scatter runs every round
    (a round without stores writes only the sink), so a round never waits
    on the host.
  * Scatters with duplicate indices resolve explicitly (``scatter_last``):
    the highest flat lane index wins, as the reference's sequential
    last-update-wins scatter does, where a CUDA scatter would leave the
    order undefined. ``mode="drop"`` lanes go to a dummy slot that is
    sliced away.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.registry import MEMSYS


def scatter_last(dst, idx, vals):
    """``dst[idx[i]] = vals[i]`` for every flat i, where among several i
    naming one slot the highest i wins. ``dst`` is 1-D and updated in
    place; every lane naming a slot writes the winner's value, so the
    scatter's own order cannot matter."""
    idx = idx.reshape(-1).long()
    vals = vals.reshape(-1)
    lane = torch.arange(idx.numel(), device=idx.device)
    winner = torch.full(dst.shape, -1, dtype=torch.long, device=dst.device)
    winner.scatter_reduce_(0, idx, lane, reduce="amax")
    dst[idx] = vals[winner[idx]]
    return dst


def unique_count(vals, valid, sentinel, axis=-1):
    """Number of distinct ``vals`` among ``valid`` entries, per row (int32).
    Sort-based: invalid entries map to ``sentinel``, which must exceed any
    valid value; a sorted run's first element marks each distinct value."""
    v = torch.where(valid, vals, sentinel).sort(dim=axis).values
    n = v.shape[axis]
    first = torch.cat(
        [torch.ones_like(v.narrow(axis, 0, 1), dtype=torch.bool),
         v.narrow(axis, 1, n - 1) != v.narrow(axis, 0, n - 1)], dim=axis)
    return (first & (v != sentinel)).sum(dim=axis, dtype=torch.int32)


class CacheResult(NamedTuple):
    tags: torch.Tensor          # updated tag state
    hit: torch.Tensor           # (W, L) bool — lanes that hit
    miss: torch.Tensor          # (W, L) bool — lanes that missed
    hit_service: torch.Tensor   # (n_elems,) int32 — mover cycles, hit traffic
    fill_cycles: torch.Tensor   # (n_elems,) int32 — DRAM fill cycles


def load_store(mem, addr, store_val, exec_m, is_load, is_store, sink: int):
    """Functional memory access, identical for every organization.

    Masked store: inactive lanes write the sink slot (index ``sink``, the
    last word); masked load: inactive lanes read the sink (never written
    back). Updates ``mem`` in place. Returns (mem, loaded, mem_mask)."""
    mem_mask = exec_m & (is_load | is_store)
    loaded = mem[torch.where(mem_mask, addr, sink)]
    waddr = torch.where(exec_m & is_store, addr, sink)
    scatter_last(mem, waddr, store_val)
    return mem, loaded, mem_mask


def _fill_tags(tags, slot_of_lane, miss, tag):
    """New tag state: every missing lane fills its slot with its tag
    (highest lane wins a shared slot); other lanes go to a dummy slot."""
    n = tags.numel()
    flat = torch.cat([tags.reshape(-1), tags.new_zeros(1)])
    scatter_last(flat, torch.where(miss, slot_of_lane, n), tag)
    return flat[:n].view_as(tags)


def _per_elem_sum(x, n_elems: int):
    return x.reshape(n_elems, -1).sum(dim=1, dtype=torch.int32)


@dataclass(frozen=True)
class SharedCache:
    """One central multi-port cache shared by all CUs (the paper's model);
    one such cache per simulated element."""
    name: str = "shared"

    def init_tags(self, cfg, n_elems: int, device=None) -> torch.Tensor:
        return torch.full((n_elems, cfg.cache_lines), -1, dtype=torch.int32,
                          device=device)

    def access(self, tags, addr, mem_mask, *, cu_of_w, elem_of_w,
               n_elems: int, cfg) -> CacheResult:
        line_shift = int(np.log2(cfg.line_words))
        line = (addr >> line_shift) % cfg.cache_lines
        tag = addr >> line_shift
        elem_b = elem_of_w[:, None].expand_as(addr)
        line_m = torch.where(mem_mask, line, 0)
        hit = (tags[torch.where(mem_mask, elem_b, 0), line_m] == tag) \
            & mem_mask
        miss = mem_mask & ~hit
        new_tags = _fill_tags(tags, elem_b * cfg.cache_lines + line, miss,
                              tag)
        # Port traffic: lanes of one wavefront coalesce into per-line
        # requests, but DISTINCT wavefronts issue distinct requests even for
        # the same line -> count per-wavefront unique hit lines. DRAM fills
        # coalesce globally (MSHR): count per-element-unique missed lines.
        hit_lines = _per_elem_sum(unique_count(line, hit, cfg.cache_lines),
                                  n_elems)
        miss_lines = unique_count(line.reshape(n_elems, -1),
                                  miss.reshape(n_elems, -1), cfg.cache_lines)
        hit_service = (hit_lines + cfg.ports - 1) // cfg.ports
        fill_cycles = miss_lines * cfg.dram_line_cycles
        return CacheResult(new_tags, hit, miss, hit_service, fill_cycles)


@dataclass(frozen=True)
class BankedPerCUCache:
    """Per-CU private banks; each bank has its own movers and fills its own
    missed lines — the DSE counterpoint to the shared organization.
    ``iso_capacity`` splits ``cfg.cache_lines`` across the banks."""
    iso_capacity: bool = False

    @property
    def name(self) -> str:
        return "banked-iso" if self.iso_capacity else "banked"

    def lines(self, cfg) -> int:
        if self.iso_capacity:
            return max(1, cfg.cache_lines // cfg.n_cus)
        return cfg.cache_lines

    def init_tags(self, cfg, n_elems: int, device=None) -> torch.Tensor:
        return torch.full((n_elems * cfg.n_cus, self.lines(cfg)), -1,
                          dtype=torch.int32, device=device)

    def access(self, tags, addr, mem_mask, *, cu_of_w, elem_of_w,
               n_elems: int, cfg) -> CacheResult:
        n_cus = cfg.n_cus
        lines = self.lines(cfg)
        n_banks = n_elems * n_cus
        line_shift = int(np.log2(cfg.line_words))
        line = (addr >> line_shift) % lines
        tag = addr >> line_shift
        bank_of_w = elem_of_w * n_cus + cu_of_w                 # (W,)
        bank_b = bank_of_w[:, None].expand_as(addr)
        line_m = torch.where(mem_mask, line, 0)
        hit = (tags[torch.where(mem_mask, bank_b, 0), line_m] == tag) \
            & mem_mask
        miss = mem_mask & ~hit
        slot = bank_b * lines + line
        new_tags = _fill_tags(tags, slot, miss, tag)
        # Per-wavefront unique hit lines (lane coalescing), summed per
        # bank; banks run concurrently -> an element's slowest bank sets
        # its service time.
        per_wf = unique_count(line, hit, lines)                 # (W,)
        per_bank = torch.zeros(n_banks, dtype=torch.int32,
                               device=addr.device).index_add_(
            0, bank_of_w, per_wf)
        hit_service = ((per_bank.view(n_elems, n_cus) + cfg.ports - 1)
                       // cfg.ports).amax(dim=1)
        # Per-bank unique missed slots each pay a DRAM fill on the shared
        # AXI path (no cross-CU coalescing: distinct banks fill separately).
        fill_cycles = unique_count(slot.reshape(n_elems, -1),
                                   miss.reshape(n_elems, -1),
                                   n_banks * lines) * cfg.dram_line_cycles
        return CacheResult(new_tags, hit, miss, hit_service, fill_cycles)


MEMSYS.register("shared", SharedCache())
MEMSYS.register("banked", BankedPerCUCache(iso_capacity=False))
MEMSYS.register("banked-iso", BankedPerCUCache(iso_capacity=True))


class _MemsysMapping(Mapping):
    """Read-only mapping view of the ``MEMSYS`` registry axis (the
    reference's ``MEMSYS_REGISTRY``): iteration and membership reflect
    every registered organization, drop-in plugins included."""

    def __getitem__(self, name: str):
        return MEMSYS.get(name)

    def __iter__(self):
        return iter(MEMSYS.names())

    def __len__(self) -> int:
        return len(MEMSYS)


MEMSYS_REGISTRY: Mapping = _MemsysMapping()


def get_memsys(name: str):
    """Resolve a memory-system name through the registry (its
    ``UnknownPluginError`` is a ``KeyError`` naming the choices)."""
    return MEMSYS.get(name)
