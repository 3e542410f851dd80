"""Shared layer math (the port's ``repro.models.layers``): norms, linear
layers, the MLPs, rotary embeddings (RoPE and Qwen2-VL's M-RoPE),
embedding, unembedding and the loss.

Inside the sharded train step (``sharding.ctx.sharded``) the MLP, the
embedding and the loss compute this rank's parts, Megatron style: a
column-parallel ``wi`` on the whole sequence and a row-parallel ``wo``
whose partial sums are reduce-scattered back to the rank's part of the
residual (``mlp_tp``; SwiGLU's fused gate|up columns first exchanged into
(gate, up) pairs, ``ctx.swiglu_pairs``), a vocab-parallel lookup
(``embed_tokens``) and a vocab-parallel cross entropy
(``vocab_parallel_ce``), each where the rules split the weight over
"model"; a layer whose weights are not split runs whole on every rank
(``ctx.whole_block``).

Parameters live in ``nn.Module`` containers whose leaves keep the
reference's names (``norm.scale``, ``wq.w``, ``wi.b``, ...). They are
stored in ``cfg.param_dtype`` (float32) and cast to ``cfg.compute_dtype``
where they are used, as the reference does. The functions mirror the
reference's, one for one, and take the modules in place of its dict
subtrees. Parameters are made without gradients, for serving; a trainer
turns them on (``model.requires_grad_()``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.sharding import ctx


def cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def param(shape, cfg: ModelConfig, device) -> nn.Parameter:
    """An uninitialised parameter (``convert`` fills it)."""
    return nn.Parameter(torch.empty(shape, dtype=pdt(cfg), device=device),
                        requires_grad=False)


class Linear(nn.Module):
    """``w`` (d_in, d_out) and, with ``bias``, ``b`` (d_out,)."""

    def __init__(self, d_in: int, d_out: int, cfg: ModelConfig, device,
                 bias: bool = False):
        super().__init__()
        self.w = param((d_in, d_out), cfg, device)
        self.b = param((d_out,), cfg, device) if bias else None


class Norm(nn.Module):
    """``scale`` and, for LayerNorm (or with ``bias``), ``bias``."""

    def __init__(self, d: int, cfg: ModelConfig, device, bias=None):
        super().__init__()
        if bias is None:
            bias = cfg.norm == "layernorm"
        self.scale = param((d,), cfg, device)
        self.bias = param((d,), cfg, device) if bias else None


class MLP(nn.Module):
    """``norm``, ``wi``, ``wo``: SwiGLU's ``wi`` is the fused gate|up;
    the GELU MLP's ``wi`` and ``wo`` carry biases."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        gelu = cfg.mlp != "swiglu"
        self.norm = Norm(d, cfg, device)
        self.wi = Linear(d, ff if gelu else 2 * ff, cfg, device, bias=gelu)
        self.wo = Linear(ff, d, cfg, device, bias=gelu)


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.w = param((cfg.vocab_size, cfg.d_model), cfg, device)


# ---------------------------------------------------------------------------
# norms / linear / mlp
# ---------------------------------------------------------------------------

def apply_norm(p: Norm, x, cfg: ModelConfig):
    """RMSNorm or LayerNorm, computed in f32, returned in compute dtype."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True)
                              + cfg.norm_eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    out = xf * p.scale.float()
    if p.bias is not None:
        out = out + p.bias.float()
    return out.to(cdt(cfg))


def rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head RMS norm of the mLSTM's output: computed in f32, returned
    in ``x``'s dtype."""
    return (head_rms(x, eps) * scale.float()).to(x.dtype)


def head_rms(x, eps: float = 1e-6):
    """``x`` over its RMS along the last dim, in f32 (``rms_head_norm``
    before its scale)."""
    xf = x.float()
    return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)


def linear(p: Linear, x, cfg: ModelConfig):
    y = x @ p.w.to(cdt(cfg))
    if p.b is not None:
        y = y + p.b.to(cdt(cfg))
    return y


def seq_norm(p: Norm):
    """``p`` as read by this rank's part of a sequence-split residual
    stream inside the sharded step: its scale and bias gradients summed
    over "model" (``ctx.seq_param``); ``p`` itself elsewhere."""
    if ctx.sharded() is None:
        return p
    return _NormView(ctx.seq_param(p.scale),
                     None if p.bias is None else ctx.seq_param(p.bias))


class _NormView:
    def __init__(self, scale, bias):
        self.scale, self.bias = scale, bias


def row_out(partial, b, cfg: ModelConfig):
    """A row-parallel product's partial sums as this rank's part of the
    residual stream (reduce-scattered, or all-reduced where the stream is
    whole), plus the bias every rank holds whole."""
    out = ctx.shard_hint(partial, "acts", "partial")
    if b is not None:
        out = out + ctx.seq_param(b).to(cdt(cfg))
    return out


def apply_mlp(p: MLP, x, cfg: ModelConfig):
    if ctx.sharded() is not None:
        return mlp_tp(p, x, cfg)
    return _mlp(p, x, cfg)


def mlp_tp(p: MLP, x, cfg: ModelConfig):
    """The MLP of this rank's part ``x`` of the residual stream: ``wi``
    column-parallel, ``wo`` row-parallel, where the rules split both over
    "model"; else whole on every rank."""
    if ctx.split_dim(p.wi.w) != 1 or ctx.split_dim(p.wo.w) != 0:
        return ctx.whole_block(p, lambda xw: _mlp(p, xw, cfg), x)
    st = ctx.sharded()
    h = ctx.whole_seq(apply_norm(seq_norm(p.norm), x, cfg), grad_sum=True)
    if cfg.mlp == "swiglu":
        w = ctx.swiglu_pairs(p.wi.w.to(cdt(cfg)), st.model)
        g, u = (h @ w).chunk(2, dim=-1)
        h = F.silu(g) * u
    else:
        h = F.gelu(linear(p.wi, h, cfg), approximate="tanh")
    return row_out(h @ p.wo.w.to(cdt(cfg)), p.wo.b, cfg)


def _mlp(p: MLP, x, cfg: ModelConfig):
    h = apply_norm(p.norm, x, cfg)
    if cfg.mlp == "swiglu":
        g, u = linear(p.wi, h, cfg).chunk(2, dim=-1)          # gate first
        h = F.silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(p.wi, h, cfg), approximate="tanh")
    return linear(p.wo, h, cfg)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(hd: int, theta: float, device):
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd), positions: broadcastable to (..., S). The two
    halves of the head dim rotate together (not interleaved pairs)."""
    inv = _rope_freqs(x.shape[-1], theta, x.device)           # (hd/2,)
    return _rotate(x, positions[..., None].float() * inv)


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL's multimodal RoPE. positions3: (3, ..., S), the (t, h, w)
    streams; the hd/2 frequencies are split into ``sections`` (summing to
    hd/2), each rotated by its own stream."""
    hd = x.shape[-1]
    inv = _rope_freqs(hd, theta, x.device)                    # (hd/2,)
    # the stream of each frequency, by section
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device), output_size=hd // 2)
    pos = positions3.index_select(0, sec_id)                  # (hd/2, ..., S)
    return _rotate(x, pos.movedim(0, -1).float() * inv)       # (..., S, hd/2)


def _rotate(x, ang):
    """x (..., S, H, hd) rotated by angles (..., S, hd/2), in f32."""
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding / loss
# ---------------------------------------------------------------------------

def embed_tokens(p: Embed, tokens, cfg: ModelConfig):
    """The rows of ``p.w``. ``F.embedding``, not ``p.w[tokens]``: the
    latter's backward (``index_put_`` accumulating) adds repeated tokens'
    rows with atomics on the CPU, in an order that changes run to run.
    Where the sharded step holds this rank's vocabulary rows, the rows of
    the tokens it holds and zeros elsewhere: a partial sum over
    "model"."""
    if ctx.split_dim(p.w) != 0:
        return F.embedding(tokens.long(), p.w).to(cdt(cfg))
    v = p.w.shape[0]
    t = tokens.long() - ctx.sharded().model.rank * v
    inside = (t >= 0) & (t < v)
    rows = F.embedding(torch.where(inside, t, 0), p.w)
    return (rows * inside[..., None]).to(cdt(cfg))


def unembed_split(model, cfg: ModelConfig) -> bool:
    """Whether the sharded step holds this rank's vocabulary part of the
    unembedding (the tied embedding's rows or ``lm_head``'s columns)."""
    if cfg.tie_embeddings:
        return ctx.split_dim(model.embed.w) == 0
    return ctx.split_dim(model.lm_head.w) == 1


def unembed(model, x, cfg: ModelConfig):
    """Logits of ``x``: the tied embedding or ``lm_head``."""
    if cfg.tie_embeddings:
        return x @ model.embed.w.to(cdt(cfg)).T
    return linear(model.lm_head, x, cfg)


def cross_entropy(logits, labels, mask=None):
    """Mean token CE in f32. logits: (..., V), labels: (...) integer."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def vocab_parallel_ce(logits, labels, ax):
    """``cross_entropy`` of logits split along the vocabulary over ``ax``
    (this rank's block of V / n columns): the max and the sum of the
    logsumexp all-reduced, the target's logit from the rank that holds
    it (the others add zeros). Every rank returns the whole mean."""
    import torch.distributed as dist
    logits = logits.float()
    v = logits.shape[-1]
    m = ctx.all_reduce(logits.detach().amax(dim=-1), ax, dist.ReduceOp.MAX)
    se = ctx.reduce_sum(torch.exp(logits - m[..., None]).sum(dim=-1), ax)
    lse = torch.log(se) + m
    t = labels.long() - ax.rank * v
    inside = (t >= 0) & (t < v)
    ll = logits.gather(-1, torch.where(inside, t, 0)[..., None])[..., 0]
    ll = ctx.reduce_sum(ll * inside, ax)
    return (lse - ll).mean()
