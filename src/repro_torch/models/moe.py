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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Norm, apply_norm, cdt, param
from repro_torch.sharding.ctx import batch_mean, shard_hint


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
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.topk
    dt = cdt(cfg)
    cap = capacity(s, cfg)

    hx = apply_norm(p.norm, x, cfg)                          # (B, S, d)
    probs, gates, experts = route(hx, p.router.w, k)
    slot, keep = _slots(experts, e, cap)

    # dispatch: each kept (token, choice) pair into its own slot
    src = hx.repeat_interleave(k, dim=1) * keep[..., None].to(dt)
    rows = torch.arange(b, device=x.device)[:, None].expand_as(slot)
    buf = torch.zeros((b, e * cap + 1, d), dtype=dt, device=x.device)
    buf = buf.index_put((rows, slot), src)
    buf = shard_hint(buf[:, :e * cap].reshape(b, e, cap, d), "expert_buf4")

    # the expert FFN (SwiGLU)
    gu = torch.einsum("becd,edf->becf", buf, p.wi.to(dt))
    g, u = gu.chunk(2, dim=-1)
    out_buf = shard_hint(torch.einsum("becf,efd->becd", F.silu(g) * u,
                                      p.wo.to(dt)), "expert_buf4")

    # combine: each pair's row (the sink a fresh zero row), gate-weighted,
    # summed over the k choices
    flat = torch.cat([out_buf.reshape(b, e * cap, d),
                      torch.zeros((b, 1, d), dtype=dt, device=x.device)], 1)
    gathered = flat[rows, slot]                              # (B, S*K, d)
    wts = (gates.reshape(b, s * k) * keep).to(dt)
    out = (gathered * wts[..., None]).reshape(b, s, k, d).sum(dim=2)

    # load-balancing aux from the first choice
    # (over the global batch when the sharded step splits its rows)
    frac_tokens = batch_mean(
        F.one_hot(experts[..., 0], e).float().mean(dim=(0, 1)))
    frac_probs = batch_mean(probs.mean(dim=(0, 1)))
    aux = e * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_coef
    return out, aux
