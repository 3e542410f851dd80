"""Shared layer math (the port's ``repro.models.layers``): norms, linear
layers, the MLP, rotary embeddings, embedding and unembedding.

Parameters live in ``nn.Module`` containers whose leaves keep the
reference's names (``norm.scale``, ``wq.w``, ``wi.b``, ...). They are
stored in ``cfg.param_dtype`` (float32) and cast to ``cfg.compute_dtype``
where they are used, as the reference does. The functions mirror the
reference's, one for one, and take the modules in place of its dict
subtrees. Serving only: parameters take no gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig


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
    """RMSNorm's ``scale``."""

    def __init__(self, d: int, cfg: ModelConfig, device):
        super().__init__()
        self.scale = param((d,), cfg, device)


class MLP(nn.Module):
    """SwiGLU: ``norm``, ``wi`` (fused gate|up), ``wo``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.norm = Norm(d, cfg, device)
        self.wi = Linear(d, 2 * ff, cfg, device)
        self.wo = Linear(ff, d, cfg, device)


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.w = param((cfg.vocab_size, cfg.d_model), cfg, device)


# ---------------------------------------------------------------------------
# norms / linear / mlp
# ---------------------------------------------------------------------------

def apply_norm(p: Norm, x, cfg: ModelConfig):
    """RMSNorm, computed in f32, returned in compute dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + cfg.norm_eps)
    return (xf * p.scale.float()).to(cdt(cfg))


def linear(p: Linear, x, cfg: ModelConfig):
    y = x @ p.w.to(cdt(cfg))
    if p.b is not None:
        y = y + p.b.to(cdt(cfg))
    return y


def apply_mlp(p: MLP, x, cfg: ModelConfig):
    h = apply_norm(p.norm, x, cfg)
    g, u = linear(p.wi, h, cfg).chunk(2, dim=-1)              # gate first
    return linear(p.wo, F.silu(g) * u, cfg)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(hd: int, theta: float, device):
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd), positions: broadcastable to (..., S). The two
    halves of the head dim rotate together (not interleaved pairs)."""
    hd = x.shape[-1]
    inv = _rope_freqs(hd, theta, x.device)                    # (hd/2,)
    ang = positions[..., None].float() * inv                  # (..., S, hd/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(p: Embed, tokens, cfg: ModelConfig):
    return p.w[tokens].to(cdt(cfg))


def unembed(model, x, cfg: ModelConfig):
    """Logits of ``x``: the tied embedding or ``lm_head``."""
    if cfg.tie_embeddings:
        return x @ model.embed.w.to(cdt(cfg)).T
    return linear(model.lm_head, x, cfg)
