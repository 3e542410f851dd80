"""Scheduler stage: resident-wavefront selection and the lockstep-round
cycle model (PyTorch port of ``repro.ggpu.engine.scheduler``).

One "round" = every resident wavefront issues one instruction. The round
time is max(slowest CU's issue work, memory hit service) plus the DRAM fill
term. Both helpers operate on a cohort of ``n_elems`` independent machines
folded into the wavefront axis (element e owns wavefronts
[e*W, (e+1)*W)); cycle accounting is per element.
"""
from __future__ import annotations

import torch


def select_resident(done, *, n_cus: int, max_wf_per_cu: int,
                    n_elems: int = 1):
    """FGPU holds at most ``max_wf_per_cu`` resident wavefronts per CU:
    rank each live wavefront within its element's CU (w = i*n_cus + cu
    order) and run only the first ``max_wf_per_cu``. When every machine
    can hold all of its wavefronts at once the ranking is statically a
    no-op and is skipped.

    Returns (active (W, L) lane mask, resident (W,) wavefront mask)."""
    W = done.shape[0] // n_elems
    active = ~done                                       # (n_elems*W, L)
    live = active.any(dim=1)                             # (n_elems*W,)
    if W <= n_cus * max_wf_per_cu:
        resident = live
    else:
        live_mat = live.view(n_elems, -1, n_cus)
        rank = torch.cumsum(live_mat.to(torch.int32), dim=1) - 1
        resident = (live_mat & (rank < max_wf_per_cu)).reshape(-1)
    return active & resident[:, None], resident


def round_cost(op_col, exec_m, *, extra, issue_cycles: int, cu_of_w,
               n_cus: int, n_elems: int, hit_service, fill_cycles,
               pipe_stall=None):
    """Per-element cycle cost of one lockstep round: issue cycles (+
    non-pipelined op extras) summed over each CU's issuing wavefronts,
    against the hit traffic streaming through the data movers, plus the
    DRAM fill term. ``pipe_stall`` ((n_elems*W,) int32 or None) adds the
    pipeline-latency feedback. Returns (round_cycles (n_elems,) int32,
    wf_exec (W,) bool)."""
    wf_exec = exec_m.any(dim=1)                          # (n_elems*W,)
    base = (issue_cycles + extra[op_col]) * wf_exec.to(torch.int32)
    if pipe_stall is not None:
        base = base + pipe_stall
    W = base.shape[0] // n_elems
    if W % n_cus == 0:
        # within an element, cu_of_w = w % n_cus: reshape-sum == scatter-add
        cu_issue = base.view(n_elems, -1, n_cus).sum(dim=1, dtype=torch.int32)
    else:
        elem_of_w = torch.arange(n_elems, device=base.device,
                                 dtype=torch.int32).repeat_interleave(W)
        cu_issue = torch.zeros(n_elems * n_cus, dtype=torch.int32,
                               device=base.device).index_add_(
            0, elem_of_w * n_cus + cu_of_w, base).view(n_elems, n_cus)
    round_t = torch.maximum(cu_issue.amax(dim=1), hit_service) + fill_cycles
    return round_t.to(torch.int32), wf_exec
