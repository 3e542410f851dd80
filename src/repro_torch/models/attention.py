"""Attention (the port's ``repro.models.attention``): GQA with RoPE,
full / sliding-window / local variants, prefill and decode.

Prefill runs the CUDA kernel ``flash_attention`` through the head-fold
wrapper when ``cfg.use_kernels`` is set (its plain version on CPU
tensors), and the plain full-matrix attention otherwise; the latter takes
the place of the reference's non-Pallas ``blocked_attention`` /
``windowed_attention``, which compute the same function in chunks.
Decode is plain PyTorch, as the reference computes it outside any Pallas
kernel: ``decode_attention`` over a full cache, ``_decode_ring`` over a
ring-buffer window cache.

Shapes: q (B,S,H,hd); k,v (B,Skv,Hkv,hd); GQA folds H = Hkv * G.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF, attention_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Linear, Norm, apply_norm, apply_rope, \
    cdt, linear


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, Smax, Hkv, hd)
    v: torch.Tensor


class AttnMixer(nn.Module):
    """``norm``, ``wq``, ``wk``, ``wv``, ``wo`` as in the reference."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
        self.norm = Norm(d, cfg, device)
        self.wq = Linear(d, q_dim, cfg, device, bias=cfg.attn_bias)
        self.wk = Linear(d, kv_dim, cfg, device, bias=cfg.attn_bias)
        self.wv = Linear(d, kv_dim, cfg, device, bias=cfg.attn_bias)
        self.wo = Linear(q_dim, d, cfg, device)


def _fold_gqa(q, n_kv: int):
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def plain_attention(q, k, v, *, causal: bool, window: int, scale: float):
    """The plain prefill path: (B,S,H,hd) attention as one full-matrix
    masked softmax in f32 (``attention_ref`` under the head fold)."""
    o = attention_ref(*kops.fold_heads(q, k, v), causal=causal,
                      window=window, scale=scale)
    return kops.unfold_heads(o, q.shape[0])


def _softmax_out(qf, cache: KVCache, valid, scale: float):
    b, _, hkv, g, hd = qf.shape
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, cache.k.float()) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, cache.v.float())
    return out.movedim(3, 1).reshape(b, 1, hkv * g, hd)


def decode_attention(q, cache: KVCache, pos: int, *, window: int,
                     scale: float):
    """Single-token attention against a cache. q: (B,1,H,hd); pos: the
    current position (pos + 1 valid cache entries after the insert)."""
    hkv = cache.k.shape[2]
    qf = _fold_gqa(q, hkv).float()                            # (B,1,Hkv,G,hd)
    kpos = torch.arange(cache.k.shape[1], device=q.device)
    valid = kpos <= pos
    if window > 0:
        valid &= kpos > pos - window
    return _softmax_out(qf, cache, valid, scale)


def _decode_ring(q, cache: KVCache, pos: int, window: int, scale: float):
    """Decode attention over a ring-buffer window cache (size == window):
    slot i holds the position p_i = i (mod window) of the last write; it
    is stale only before the buffer first fills."""
    hkv = cache.k.shape[2]
    qf = _fold_gqa(q, hkv).float()
    idx = torch.arange(window, device=q.device)
    age = (pos - idx) % window                                # distance back
    valid = (pos - age) >= 0
    return _softmax_out(qf, cache, valid, scale)


def attn_block(p: AttnMixer, x, cfg: ModelConfig, kind: str, *,
               positions=None, cache: Optional[KVCache] = None,
               cache_pos: Optional[int] = None):
    """Returns (out, cache). kind: attn | swa | local.

    Prefill: ``cache`` is None and the second result is the (k, v) the
    caller turns into a decode cache. Decode: ``cache`` is given and x is
    (B,1,d); the new k, v are written into it in place (the reference
    returns an updated copy) and the same cache is returned.
    """
    b, s, _ = x.shape
    hd = cfg.hd
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    window = cfg.window if kind in ("swa", "local") else 0
    scale = hd ** -0.5

    hx = apply_norm(p.norm, x, cfg)
    q = linear(p.wq, hx, cfg).reshape(b, s, h, hd)
    k = linear(p.wk, hx, cfg).reshape(b, s, hkv, hd)
    v = linear(p.wv, hx, cfg).reshape(b, s, hkv, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:                                     # decode
        slot = cache_pos if window == 0 else cache_pos % cache.k.shape[1]
        cache.k[:, slot:slot + s] = k.to(cache.k.dtype)
        cache.v[:, slot:slot + s] = v.to(cache.v.dtype)
        if window == 0:
            out = decode_attention(q, cache, cache_pos, window=0,
                                   scale=scale)
        else:
            # ring-buffer cache of size window: every live entry is in range
            out = _decode_ring(q, cache, cache_pos, window, scale)
        out = out.reshape(b, s, h * hd)
        return linear(p.wo, out.to(cdt(cfg)), cfg), cache

    attend = kops.flash_attention if cfg.use_kernels else plain_attention
    out = attend(q, k, v, causal=cfg.causal, window=window, scale=scale)
    out = out.reshape(b, s, h * hd).to(cdt(cfg))
    return linear(p.wo, out, cfg), KVCache(k, v)
