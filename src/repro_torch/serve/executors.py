"""Executor layer: runs planned chunks on one device config (PyTorch port
of ``repro.serve.executors``).

An ``Executor`` owns the engine entry points for one ``GGPUConfig`` on one
torch device and counts its **envelope cache**: the set of chunk
signatures (kind, batch size, wavefront count, program length, memory
size, opcode set, placement) it has dispatched. The keys are the
reference's, including the ``cohort_rows`` bucket for cohorts, so the
hit/miss counters equal the reference's on the same traffic. In the
reference a miss is a jit trace and compile; eager PyTorch compiles
nothing, so here the counters count repeat envelopes, nothing more.

Every executor separates its **simulation config** (``sim_cfg``:
``freq_mhz`` normalized out — frequency never enters the cycle
computation) from its **reporting config** (``cfg``: the caller's true
frequency). ``Result.info["time_us"]`` is rescaled from cycles at the
true ``freq_mhz``, so executors at different frequency targets of one
design share one envelope cache, stats and memo.

``submit`` stages and dispatches a chunk and returns a ``PendingChunk``;
``collect`` resolves it into ``Result``s (the small cycles/stats arrays,
plus each request's declared ``out_region`` slice of memory, or the full
image when none was declared); ``run`` is the two in a row. Dispatch is
not overlapped with the host in the port: ``submit`` returns after the
chunk has retired on the device (``repro_torch.ggpu.engine.stepper``), so
a pipelined drain gives the same results and no overlap.

``timeout_s`` is the wall-clock budget a dispatched chunk gets before
``collect`` gives up with ``DeviceTimeout``. ``PendingChunk.t_dispatch``
is stamped when ``submit`` returns, which in the port is after the chunk
has retired; the reference stamps after its asynchronous dispatch
returns. Either way the budget counts only time past the dispatch call,
so an ordinary chunk is ready (``chunk_ready``: its CUDA event) by the
time it is collected, and only a chunk that something holds back — a
fault injector's straggler or stuck device (``repro_torch.faults``) — can
run out of it.

An executor carries its **placement**: a ``device`` (resolved by
``repro_torch._device``, the card by default) and optionally a ``mesh``
(``repro_torch.launch.mesh.LaunchMesh``) that shards every cohort and
batch chunk's launch axis, one folded machine per mesh entry
(``repro_torch.ggpu.engine`` ``mesh=`` entry points). ``shards`` is the
mesh's extent (1 without one); schedulers plan ``shards`` times wider
chunks. A mesh executor's single launches, and every launch when the
extent is 1, run unsharded on ``device`` (default: the mesh's first
entry). The placement enters the envelope key.

``get_executor`` is a process-wide registry keyed by the simulation key
*and the placement's devices*, so a CPU executor's memo never answers a
card query, nor one card's another's: a mesh that repeats one device
shares that device's canonical state, a mesh over several devices has its
own. Callers with a non-default frequency or a mesh get a view that
shares the canonical executor's envelope cache, stats and memo but
reports at their true frequency. The DSE ``Evaluator`` keeps its cycle
cache on these executors (``Executor.memo``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.ggpu.engine import (BlockPatch, GGPUConfig,
                                     KernelLaunchError, LaunchHandle,
                                     XorBlockPatch, cohort_rows,
                                     launch_shards, run_kernel_async,
                                     run_kernel_batch_async,
                                     run_kernel_cohort_async)
from repro_torch.ggpu.engine.stepper import _n_wavefronts, _placement
from repro_torch.serve.request import Request, Result


class DeviceTimeout(KernelLaunchError):
    """A dispatched chunk did not resolve within the executor's
    ``timeout_s`` — the stuck-device failure mode. ``index`` is ``None``:
    the whole chunk is suspect, every member is retried or quarantined by
    the scheduler. ``device_fault`` marks it as the *device's* failure (not
    the program's), which is what a fleet counts toward eviction and
    re-routes to survivors."""

    device_fault = True

    def __init__(self, message: str, index: Optional[int] = None):
        super().__init__(message, 0 if index is None else index)
        self.index = index


@dataclasses.dataclass
class ExecutorStats:
    """Counts *executed* work: a launch re-run after a failed chunk counts
    each time it actually runs. hits + misses == dispatches always holds,
    and both are counted at *collection* (a dispatch that fails to halt
    is retried with fewer members, a different envelope)."""
    launches: int = 0        # kernel launches executed
    dispatches: int = 0      # folded machine runs issued
    trace_hits: int = 0      # dispatches whose envelope was seen before
    trace_misses: int = 0    # dispatches with a new envelope

    @property
    def batch_occupancy(self) -> float:
        """Mean launches per dispatch — the continuous-batching win."""
        return self.launches / self.dispatches if self.dispatches else 0.0

    @property
    def hit_rate(self) -> float:
        return (self.trace_hits / self.dispatches) if self.dispatches else 0.0

    def report(self) -> dict:
        return {
            "launches": self.launches,
            "dispatches": self.dispatches,
            "batch_occupancy": round(self.batch_occupancy, 3),
            "trace_hits": self.trace_hits,
            "trace_misses": self.trace_misses,
            "hit_rate": round(self.hit_rate, 3),
        }


def sim_key(cfg: GGPUConfig) -> GGPUConfig:
    """Normalize ``freq_mhz`` out of the executor key: frequency scales
    reported ``time_us`` but never the cycle computation."""
    return dataclasses.replace(cfg, freq_mhz=500.0)


@dataclasses.dataclass
class PendingChunk:
    """One dispatched chunk awaiting collection. ``t_dispatch`` is the
    monotonic clock when ``submit`` returned — the reference point for
    executor timeouts and fleet-level hedging."""
    handle: LaunchHandle
    kind: str
    reqs: List[Request]
    env: tuple
    traced: bool
    t_dispatch: float = 0.0


class Executor:
    """Runs (kind, requests) chunks on one config and device, with
    envelope-cache accounting and a memo dict shared across its users (see
    module doc).

    ``share`` hands this executor another one's mutable state (envelope
    cache, stats, memo) — how the registry builds frequency-faithful views
    over one canonical executor per (simulation key, placement).
    ``device`` is where unsharded chunks run (``None``: the mesh's first
    entry, else the card); ``mesh`` shards cohort and batch chunks
    (module doc).
    ``timeout_s`` bounds how long ``collect`` waits on a chunk that is not
    ready (module doc)."""

    def __init__(self, cfg: GGPUConfig, *,
                 share: Optional["Executor"] = None,
                 mesh=None, device=None,
                 timeout_s: Optional[float] = None):
        self.cfg = cfg                    # reporting config (true freq)
        self.sim_cfg = sim_key(cfg)       # engine config
        self.shards = launch_shards(mesh)
        self.mesh = mesh
        self.device = _placement(mesh, device)
        self.placement = _placement_key(mesh, self.device)
        # wall-clock budget of a dispatched chunk before ``collect`` gives
        # up with ``DeviceTimeout`` (None: wait forever, the default)
        self.timeout_s = timeout_s
        if share is None:
            self.stats = ExecutorStats()
            self.memo: Dict[tuple, object] = {}  # e.g. the DSE cycle cache
            self._envelopes: set = set()
        else:
            if share.sim_cfg != self.sim_cfg:
                raise ValueError("shared executors must agree on the "
                                 "simulation key")
            if share.placement != self.placement:
                raise ValueError("shared executors must agree on the "
                                 "placement's devices")
            self.stats = share.stats
            self.memo = share.memo
            self._envelopes = share._envelopes

    # -- envelope accounting ------------------------------------------------

    def _envelope(self, kind: str, reqs: Sequence[Request]) -> tuple:
        """The reference's static signature for this chunk, suffixed with
        this executor's placement."""
        cfg = self.sim_cfg
        place = (self.shards, str(self.device) if self.mesh is None
                 else tuple(str(d) for d in self.mesh.devices))
        if kind == "cohort":
            r = reqs[0]
            return ("cohort", cohort_rows(len(reqs), self.shards),
                    _n_wavefronts(r.n_items, cfg),
                    r.prog.shape[0], r.mem0.shape[0], r.static_ops(), place)
        if kind == "batch":
            P = max(r.prog.shape[0] for r in reqs)
            M = max(r.mem0.shape[0] for r in reqs)
            W = max(_n_wavefronts(r.n_items, cfg) for r in reqs)
            ops = tuple(sorted(set().union(
                *(r.static_ops() for r in reqs))))
            return ("batch", len(reqs), W, P, M, ops, place)
        r = reqs[0]
        return ("single", _n_wavefronts(r.n_items, cfg), r.prog.shape[0],
                r.mem0.shape[0], r.static_ops(), place)

    # -- execution ----------------------------------------------------------

    def submit(self, kind: str, reqs: Sequence[Request],
               patches=None) -> PendingChunk:
        """Stage and dispatch one planned chunk; pair with ``collect``.
        ``patches`` optionally overwrites regions of the chunk's staged
        memory with device tensors before the run — a ``BlockPatch`` or
        one ``[(lo, hi, src), ...]`` list per launch — the device-resident
        chaining path a dependency-aware scheduler uses."""
        reqs = list(reqs)
        if len(reqs) == 1:
            kind = "single"          # a degenerate chunk needs no folding
        env = self._envelope(kind, reqs)
        traced = env in self._envelopes
        self._envelopes.add(env)
        regions = [r.out_region for r in reqs]
        if all(r is None for r in regions):
            regions = None
        cfg, dev = self.sim_cfg, self.device
        if kind == "cohort":
            h = run_kernel_cohort_async(
                reqs[0].prog, [r.mem0 for r in reqs], reqs[0].n_items,
                cfg, out_regions=regions, patches=patches, mesh=self.mesh,
                device=dev)
        elif kind == "batch":
            h = run_kernel_batch_async(
                [r.prog for r in reqs], [r.mem0 for r in reqs],
                [r.n_items for r in reqs], cfg, out_regions=regions,
                patches=patches, mesh=self.mesh, device=dev)
        else:
            # the chunk-level patch forms, as the single launch's flat list
            single = None
            if isinstance(patches, XorBlockPatch):
                single = [(patches.lo, patches.hi, patches.block[0], "xor")]
            elif isinstance(patches, BlockPatch):
                single = [(patches.lo, patches.hi, patches.block[0])]
            elif patches is not None:
                single = patches[0]
            h = run_kernel_async(
                reqs[0].prog, reqs[0].mem0, reqs[0].n_items, cfg,
                out_region=regions[0] if regions else None,
                patches=single, device=dev)
        return PendingChunk(h, kind, reqs, env, traced,
                            t_dispatch=time.monotonic())

    def chunk_ready(self, pending: PendingChunk) -> bool:
        """Non-blocking: has the device finished this chunk? (The hook a
        fault injector overrides to model stuck devices and stragglers.)"""
        return pending.handle.ready()

    def collect(self, pending: PendingChunk) -> List[Result]:
        """Resolve a dispatched chunk into per-launch ``Result``s in the
        chunk's own order, rescaling ``time_us`` to this executor's true
        frequency. Raises ``KernelLaunchError`` (``index`` names the
        failing position) when a launch did not halt — counters move on
        successful collections only. With ``timeout_s`` set, a chunk still
        not ready ``timeout_s`` after its dispatch raises ``DeviceTimeout``
        (``index=None``: the whole chunk is suspect)."""
        if self.timeout_s is not None:
            deadline = pending.t_dispatch + self.timeout_s
            while not self.chunk_ready(pending):
                now = time.monotonic()
                if now >= deadline:
                    raise DeviceTimeout(
                        f"chunk of {len(pending.reqs)} launch(es) not "
                        f"resolved within {self.timeout_s}s of dispatch")
                time.sleep(min(1e-3, deadline - now))
        outs = pending.handle.results()
        if pending.traced:
            self.stats.trace_hits += 1
        else:
            self.stats.trace_misses += 1
        self.stats.launches += len(pending.reqs)
        self.stats.dispatches += 1
        results = []
        for mem, info in outs:
            info.setdefault("batch_size", 1)
            info["time_us"] = info["cycles"] / self.cfg.freq_mhz
            results.append(Result(mem, info))
        return results

    def run(self, kind: str, reqs: Sequence[Request]) -> List[Result]:
        """Execute one planned chunk (dispatch + collect)."""
        return self.collect(self.submit(kind, reqs))


# -- process-wide registry (shared with repro_torch.dse.Evaluator) ----------

_EXECUTORS: Dict[tuple, Executor] = {}  # canonical, by (sim key, placement)
_VIEWS: Dict[tuple, Executor] = {}      # frequency and mesh views


def _placement_key(mesh, device):
    """What a memo may be shared across: the device when every launch
    runs there (no mesh, or a mesh that repeats ``device``), else the
    mesh."""
    if mesh is None or all(d == device for d in mesh.devices):
        return device
    return mesh


def get_executor(cfg: GGPUConfig, *, mesh=None, device=None) -> Executor:
    """The shared executor for ``cfg``'s simulation key on its placement
    (``device``, the card by default; ``mesh`` as ``Executor``), reporting
    at ``cfg``'s true frequency: a non-default-frequency or mesh-placed
    caller gets a view (keyed by frequency and placement) sharing the
    canonical executor's envelope cache, stats and memo, with ``time_us``
    rescaled at the caller's ``freq_mhz``."""
    launch_shards(mesh)                   # only a LaunchMesh shards
    dev = _placement(mesh, device)
    place = _placement_key(mesh, dev)
    key = sim_key(cfg)
    canon = _EXECUTORS.get((key, place))
    if canon is None:
        canon = _EXECUTORS.setdefault(
            (key, place), Executor(key, device=dev,
                                   mesh=None if place == dev else mesh))
    if cfg == key and mesh == canon.mesh:
        return canon
    view = _VIEWS.get((cfg, mesh, dev))
    if view is None:
        view = _VIEWS.setdefault(
            (cfg, mesh, dev), Executor(cfg, share=canon, mesh=mesh,
                                       device=dev))
    return view
