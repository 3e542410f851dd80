"""Kernel-graph serving: submit a compiled ``Program`` as a dependency
DAG of requests with device-resident inter-stage chaining (the PyTorch
port of ``repro.serve.graphs``; the target, a ``Scheduler`` or ``Fleet``,
carries its device, and every inter-stage edge is a patch on that
device's staged buffer).

``submit_program`` turns each stage of a ``repro_torch.compiler.Program`` into
one ``Request``: graph inputs are staged into the stage's memory image
host-side (they have to travel once), stage-fed arrays are left as zero
placeholders covered by ``Dep`` edges, intermediate stages declare the
empty ``out_region`` (their output is never downloaded anywhere — it
flows producer→consumer entirely on the device via the scheduler's patch
path), and only the final stage's declared output region reaches the
host. The per-stage lowering ``Schedule`` label rides along on
``Request.schedule`` so a fleet's learned service-time model keys tuned
and default lowerings separately.

Submitting N instances of the same program **stage-major** (all instances'
stage 0, then all stage 1, …) is the throughput idiom: each stage's
requests share a kernel key and fold into one cohort dispatch, and the
consumer chunk's patches collapse into a single fused ``BlockPatch`` read
of the producer chunk — one device op per edge per *chunk*, not per
request. ``submit_programs`` does exactly that.

``run_program`` is the one-shot convenience (submit, drain, return the
final stage's output). Two host-staged references bracket it:

  * ``run_chains_host_staged`` — the pre-graph DAG idiom and the bench's
    gated baseline: each instance's chain is executed stage-by-stage,
    downloading the full final image and host-re-staging it into the
    next stage's memory. Without dependency edges this is how a DAG ran:
    the per-chain barrier structure serializes every edge through the
    host *and* hides cross-chain same-kernel folding opportunities from
    the scheduler (stage 0 of chain 2 is only built after chain 1
    finished entirely).
  * ``run_programs_host_staged`` — the strongest manual workaround: the
    caller restructures the workload stage-major (all instances' stage
    k, one drain barrier, download, re-stage). This recovers cohort
    folding and is reported alongside for calibration; the remaining
    delta vs the pipelined path is the per-edge host round-trip and the
    lost cross-stage overlap, which shrink to parity on a single-core
    host where simulator compute dominates.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.serve.request import Dep, Request

if TYPE_CHECKING:
    from repro_torch.compiler.frontend import Program


class GraphTickets(NamedTuple):
    """Tickets of one submitted program instance, in stage order."""
    stages: List[int]

    @property
    def final(self) -> int:
        return self.stages[-1]


def _stage_requests(program: Program,
                    inputs: Dict[str, np.ndarray],
                    tag: str, priority: int,
                    deadline_us: float) -> List[Request]:
    """Build one program instance's per-stage requests. ``deps`` are
    expressed in *local stage indices*; ``submit_program`` rewrites them
    to real tickets as it submits."""
    inputs = {n: np.asarray(v, np.int32).reshape(-1)
              for n, v in dict(inputs).items()}
    missing = set(program.in_sizes) - set(inputs)
    if missing:
        raise ValueError(f"missing graph inputs: {sorted(missing)}")
    reqs: List[Request] = []
    for idx, ck in enumerate(program.stages):
        feed = {}
        deps: List[Dep] = []
        layout = ck.layout
        for arr, (kind, ref) in program.sources[idx].items():
            ln = ck.kernel.arrays[arr]
            if kind == "input":
                feed[arr] = inputs[ref]
            else:
                feed[arr] = np.zeros(ln, np.int32)   # placeholder words
                producer = program.stages[ref]
                deps.append(Dep(ref, (layout[arr], layout[arr] + ln),
                                (producer.out.start, producer.out.stop)))
        final = idx == len(program.stages) - 1
        reqs.append(Request(
            ck.prog, ck.build_mem(feed), ck.n_items,
            tag=f"{tag}:{ck.name}" if tag else "",
            priority=priority, deadline_us=deadline_us,
            out_region=((ck.out.start, ck.out.stop) if final else (0, 0)),
            deps=tuple(deps), schedule=ck.schedule.label()))
    return reqs


def submit_program(target, program: Program,
                   inputs: Dict[str, np.ndarray], *, tag: str = "",
                   priority: int = 0,
                   deadline_us: float = math.inf) -> GraphTickets:
    """Submit one program instance to ``target`` (a ``Scheduler`` or
    ``Fleet`` — anything with ``submit_request``) as a dependency DAG;
    returns the stage tickets. Only the final stage downloads anything;
    every inter-stage edge stays device-resident."""
    reqs = _stage_requests(program, inputs, tag, priority, deadline_us)
    tickets: List[int] = []
    for req in reqs:
        req.deps = tuple(Dep(tickets[d.producer], d.dst, d.src)
                         for d in req.deps)
        tickets.append(target.submit_request(req))
    return GraphTickets(tickets)


def submit_programs(target, program: Program,
                    instances: Sequence[Dict[str, np.ndarray]], *,
                    tag: str = "", priority: int = 0,
                    deadline_us: float = math.inf) -> List[GraphTickets]:
    """Submit N instances of ``program`` stage-major, so each stage's
    launches fold into cohort chunks and each producer→consumer edge is
    one fused device read per chunk (module doc)."""
    per_instance = [_stage_requests(program, ins, tag, priority,
                                    deadline_us)
                    for ins in instances]
    tickets: List[List[int]] = [[] for _ in per_instance]
    for stage in range(len(program.stages)):
        for inst, reqs in enumerate(per_instance):
            req = reqs[stage]
            req.deps = tuple(Dep(tickets[inst][d.producer], d.dst, d.src)
                             for d in req.deps)
            tickets[inst].append(target.submit_request(req))
    return [GraphTickets(t) for t in tickets]


def extract_outputs(results, handles: Sequence[GraphTickets]
                    ) -> List[Optional[np.ndarray]]:
    """Pick each instance's final-stage output out of a drain's results
    (``None`` where the final stage did not complete — e.g. a quarantined
    ancestor)."""
    by_ticket = {r.info["ticket"]: r.mem for r in results}
    return [by_ticket.get(h.final) for h in handles]


def run_program(target, program: Program,
                inputs: Dict[str, np.ndarray]) -> np.ndarray:
    """Submit one instance and drain: the device-resident one-shot. The
    returned array is bit-exact with ``program.reference(inputs)`` /
    ``run_host`` — the graph tests assert all three agree."""
    handle = submit_program(target, program, inputs)
    out = extract_outputs(target.drain(), [handle])[0]
    if out is None:
        raise RuntimeError(
            f"program {program.name!r}: final stage (ticket "
            f"{handle.final}) did not complete — check quarantined")
    return out


def run_chains_host_staged(target, program: Program,
                           instances: Sequence[Dict[str, np.ndarray]]
                           ) -> List[np.ndarray]:
    """The pre-graph DAG idiom (module doc): every instance's chain runs
    stage-by-stage through the host — submit one stage, drain, download
    the full final image, slice the output, re-stage it into the next
    stage's memory. The ``graph`` bench section gates the device-resident
    pipelined path against this."""
    out: List[np.ndarray] = []
    for ins in instances:
        ins = {n: np.asarray(v, np.int32).reshape(-1)
               for n, v in dict(ins).items()}
        prev: Dict[int, np.ndarray] = {}
        for idx, ck in enumerate(program.stages):
            feed = {}
            for arr, (kind, ref) in program.sources[idx].items():
                feed[arr] = ins[ref] if kind == "input" else prev[ref]
            ticket = target.submit_request(
                Request(ck.prog, ck.build_mem(feed), ck.n_items,
                        schedule=ck.schedule.label()))
            (res,) = [r for r in target.drain()
                      if r.info["ticket"] == ticket]
            prev[idx] = np.asarray(res.mem)[ck.out]
        out.append(prev[len(program.stages) - 1])
    return out


def run_programs_host_staged(target, program: Program,
                             instances: Sequence[Dict[str, np.ndarray]]
                             ) -> List[np.ndarray]:
    """The stage-major host-staged reference (module doc): execute N
    instances stage-by-stage with a drain barrier per stage, downloading
    every stage's declared output and re-staging it host-side into the
    next stage's memory image. Same cohort folding per stage as the
    device-resident path — the measured delta is purely the per-edge
    host round-trip plus the lost cross-stage pipelining."""
    instances = [{n: np.asarray(v, np.int32).reshape(-1)
                  for n, v in dict(ins).items()} for ins in instances]
    outs: List[Dict[int, np.ndarray]] = [{} for _ in instances]
    for idx, ck in enumerate(program.stages):
        tickets = []
        for inst, ins in enumerate(instances):
            feed = {}
            for arr, (kind, ref) in program.sources[idx].items():
                feed[arr] = ins[ref] if kind == "input" else outs[inst][ref]
            tickets.append(target.submit_request(Request(
                ck.prog, ck.build_mem(feed), ck.n_items,
                out_region=(ck.out.start, ck.out.stop),
                schedule=ck.schedule.label())))
        results = {r.info["ticket"]: r.mem for r in target.drain()}
        for inst, t in enumerate(tickets):
            outs[inst][idx] = results[t]
    last = len(program.stages) - 1
    return [o[last] for o in outs]


def run_program_host_staged(target, program: Program,
                            inputs: Dict[str, np.ndarray]) -> np.ndarray:
    return run_programs_host_staged(target, program, [inputs])[0]
