"""Mixture-of-Experts FFN (the port's ``repro.models.moe``): token-choice
top-k routing with per-row capacity and a scatter dispatch (Mixtral: k=2
of 8; Llama-4-Scout: k=1 of 16).

Dispatch is grouped by batch row, as in the reference: each row counts
its own position in each expert and writes into its own (E, C, d) slice,
``C`` the row's capacity. A (token, choice) pair past its expert's
capacity goes to the sink row ``E*C``, which is thrown away; its gate is
zeroed, so a dropped pair adds nothing. The capacity counts every token
of the row, the left padding of a serving wave included (``serve.llm``
pads without a mask, as the reference does).

Every kept pair has a slot of its own, so the dispatch is a plain
indexed write (``index_put`` without accumulation) of the same values the
reference's scatter-add leaves there; the sink alone takes several
writes, all zeros. The combine gathers from the expert outputs with a
fresh zero row appended for the sink. Neither step adds colliding values,
so both directions of both are deterministic on the card.

The expert products are plain PyTorch (``einsum``), as the reference
computes them outside any Pallas kernel. ``route`` and ``capacity`` are
module functions, so that a caller can observe the routing.

Returns ``(out, aux)``, aux being the load-balancing loss of the first
choice (Switch/Mixtral form).

Inside the sharded train step ``apply_moe`` runs ``moe_tp`` on this
rank's part of the residual stream. Routing, slots and capacity are
computed on the whole sequence (gathered along it), so every rank numbers
each row's (token, choice) pairs as one device does. Where the rules
split the experts over "model", each rank dispatches to and runs its own
experts (the "expert_buf4" buffer); where they split the experts' "ffn"
dim instead, each rank runs every expert on its columns of ``wi`` and
rows of ``wo``. Either way the combine is a partial sum over "model",
reduce-scattered to the rank's part of the stream; a layer whose experts
are split neither way runs whole on every rank.

Under a tracer (``repro_torch.trace``) ``apply_moe`` is the device span
``moe``, and ``_routed`` counts the layer's (token, choice) pairs
(``moe_pairs``) and those past capacity (``moe_dropped_pairs``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Norm, apply_norm, cdt, param, \
    seq_norm
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import batch_mean, shard_hint
from repro_torch.trace import current


class Router(nn.Module):
    """``w`` (d, E): the router's logits are ``hx @ w`` in f32."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.w = param((cfg.d_model, cfg.n_experts), cfg, device)


class MoE(nn.Module):
    """``norm``, ``router.w`` (d, E), ``wi`` (E, d, 2*ff) (fused
    gate|up per expert), ``wo`` (E, ff, d): the reference's leaves."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.norm = Norm(d, cfg, device)
        self.router = Router(cfg, device)
        self.wi = param((e, d, 2 * ff), cfg, device)
        self.wo = param((e, ff, d), cfg, device)


def capacity(s: int, cfg: ModelConfig) -> int:
    """Slots per expert in one batch row of ``s`` tokens: s*k/E times
    the capacity factor, at least 1, rounded up to a multiple of 4."""
    cap = int(max(1, (s * cfg.topk / cfg.n_experts) * cfg.capacity_factor))
    return ((cap + 3) // 4) * 4


def route(hx, w, k: int):
    """(probs (B, S, E), gates (B, S, K), experts (B, S, K)): the softmax
    of the f32 router logits, its top ``k`` and their renormalised gates.
    Equal probabilities rank lowest index first, as ``jax.lax.top_k``
    ranks them: a stable descending sort, since ``torch.topk`` orders
    ties otherwise (on the CPU, [0.3, 0.3, 0.3] at indices 2, 3, 5 comes
    back 3, 5, 2)."""
    logits = hx.float() @ w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[..., :k], experts[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, experts


def _slots(experts, e: int, cap: int):
    """(slot (B, S*K), keep (B, S*K)): each (token, choice) pair's row of
    the (E*C + 1)-row buffer, in token-major, choice-minor order; the
    n-th pair of a row that picks an expert takes its slot n, and pairs
    past ``cap`` the sink row ``e*cap``."""
    b = experts.shape[0]
    flat_e = experts.reshape(b, -1)                          # (B, S*K)
    onehot = F.one_hot(flat_e, e)                            # (B, S*K, E)
    position = (onehot.cumsum(1) - 1).gather(2, flat_e[..., None])[..., 0]
    keep = position < cap
    slot = torch.where(keep, flat_e * cap + position,
                       torch.full_like(flat_e, e * cap))
    return slot, keep


def apply_moe(p: MoE, x, cfg: ModelConfig):
    """The MoE FFN of (B, S, d) ``x``: (out (B, S, d), aux ())."""
    with current().span("moe", device=True):
        if ctx.sharded() is not None:
            return moe_tp(p, x, cfg)
        return _moe(p, x, cfg)


def _aux(probs, experts, e: int, cfg: ModelConfig):
    """The load-balancing loss of the first choice, its fractions over
    the global batch when the sharded step splits the rows."""
    frac_tokens = batch_mean(
        F.one_hot(experts[..., 0], e).float().mean(dim=(0, 1)))
    frac_probs = batch_mean(probs.mean(dim=(0, 1)))
    return e * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_coef


def moe_tp(p: MoE, x, cfg: ModelConfig):
    """The sharded train step's MoE FFN of this rank's part ``x`` (B, s,
    d) of the residual stream (module doc): (this rank's part of the
    output, aux)."""
    by_expert = ctx.split_dim(p.wi) == 0 and ctx.split_dim(p.wo) == 0
    by_ffn = ctx.split_dim(p.wi) == 2 and ctx.split_dim(p.wo) == 1
    if not (by_expert or by_ffn):
        return ctx.whole_block(p, lambda xw: _moe(p, xw, cfg), x)
    hx = apply_norm(seq_norm(p.norm), x, cfg)
    partial, aux = _routed(p, ctx.whole_seq(hx, grad_sum=False),
                           ctx.whole_seq(hx, grad_sum=True), cfg,
                           ctx.sharded(), by_expert)
    return shard_hint(partial, "acts", "partial"), aux


def _moe(p: MoE, x, cfg: ModelConfig):
    hx = apply_norm(p.norm, x, cfg)                          # (B, S, d)
    return _routed(p, hx, hx, cfg)


def _routed(p: MoE, h_route, h_disp, cfg: ModelConfig, st=None,
            by_expert: bool = False):
    """Route the tokens of ``h_route``, dispatch those of ``h_disp``
    (the same (B, S, d) values), run the experts and combine: (out, aux).
    In the sharded step (``st``) this rank runs its own experts
    (``by_expert``) or every expert on its "ffn" columns, and ``out`` is
    its share of a sum over "model"."""
    b, s, d = h_route.shape
    e, k = cfg.n_experts, cfg.topk
    dt = cdt(cfg)
    cap = capacity(s, cfg)
    probs, gates, experts = route(h_route, p.router.w, k)
    slot, keep = _slots(experts, e, cap)
    tr = current()
    if tr.on:
        tr.count("moe_pairs", keep.numel())
        tr.count("moe_dropped_pairs", (~keep).sum())
    n_local, wi = e, p.wi.to(dt)
    if st is not None:
        # the combine is a per-rank share: its gate gradients summed
        gates = ctx.copy(gates, st.model)
        if by_expert:                   # this rank's experts' slots only
            n_local = e // st.model.n
            lo = st.model.rank * n_local * cap
            keep = keep & (slot >= lo) & (slot < lo + n_local * cap)
            slot = torch.where(keep, slot - lo,
                               torch.full_like(slot, n_local * cap))
        else:
            wi = ctx.swiglu_pairs(wi, st.model)

    # dispatch: each kept (token, choice) pair into its own slot
    dev = h_disp.device
    src = h_disp.repeat_interleave(k, dim=1) * keep[..., None].to(dt)
    rows = torch.arange(b, device=dev)[:, None].expand_as(slot)
    buf = torch.zeros((b, n_local * cap + 1, d), dtype=dt, device=dev)
    buf = buf.index_put((rows, slot), src)
    buf = shard_hint(buf[:, :n_local * cap].reshape(b, n_local, cap, d),
                     "expert_buf4")

    # the expert FFN (SwiGLU)
    gu = torch.einsum("becd,edf->becf", buf, wi)
    g, u = gu.chunk(2, dim=-1)
    out_buf = shard_hint(torch.einsum("becf,efd->becd", F.silu(g) * u,
                                      p.wo.to(dt)), "expert_buf4")

    # combine: each pair's row (the sink a fresh zero row), gate-weighted,
    # summed over the k choices
    flat = torch.cat([out_buf.reshape(b, n_local * cap, d),
                      torch.zeros((b, 1, d), dtype=dt, device=dev)], 1)
    gathered = flat[rows, slot]                              # (B, S*K, d)
    wts = (gates.reshape(b, s * k) * keep).to(dt)
    out = (gathered * wts[..., None]).reshape(b, s, k, d).sum(dim=2)

    # load-balancing aux from the first choice
    return out, _aux(probs, experts, e, cfg)
