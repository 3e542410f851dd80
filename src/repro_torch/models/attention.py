"""Attention (the port's ``repro.models.attention``): GQA with RoPE,
full / sliding-window / local variants, prefill and decode.

Prefill runs the CUDA kernel ``flash_attention`` through the head-fold
wrapper when ``cfg.use_kernels`` is set (its plain version on CPU
tensors). Otherwise prefill and training run the reference's plain path:
``blocked_attention`` (online softmax over ``attn_q_chunk`` x
``attn_kv_chunk`` tiles) for full attention and ``windowed_attention``
(per-q-chunk KV slices) for local/SWA layers, each chunk checkpointed
under autograd so that no (B, H, S, S) tensor is held for the backward.
``plain_attention``, one full-matrix masked softmax, is the oracle the
tests hold both to. Decode is plain PyTorch, as the reference computes it
outside any Pallas kernel: ``decode_attention`` over a full cache,
``_decode_ring`` over a ring-buffer window cache.

Shapes: q (B,S,H,hd); k,v (B,Skv,Hkv,hd); GQA folds H = Hkv * G.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def remat_chunk(fn, *args):
    """``fn(*args)``, recomputed in the backward when autograd records it
    (the reference's ``jax.checkpoint`` on a chunk body)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _pad_seq(x, before: int, after: int):
    """Zero-pad dim 1 of (B, S, H, hd)."""
    return F.pad(x, (0, 0, 0, 0, before, after)) if before or after else x


def blocked_attention(q, k, v, *, causal: bool, window: int, q_offset: int,
                      chunk_q: int, chunk_kv: int, scale: float):
    """Online-softmax blocked attention (flash-style, plain PyTorch).

    Loops over q chunks (outer) and kv chunks (inner) carrying the
    running max, softmax denominator and output (the reference's m, l,
    acc); every chunk pair's scores exist only inside its checkpointed
    step, so memory is O(B·H·chunk_q·chunk_kv), not O(S²). Masked pairs
    are computed too (the reference's arithmetic, tile for tile).
    """
    b, sq, h, hd = q.shape
    skv_real, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    cq = min(chunk_q, sq)
    ck = min(chunk_kv, skv_real)
    pq, pk = (-sq) % cq, (-skv_real) % ck
    q = _fold_gqa(_pad_seq(q, 0, pq), hkv)                # (B,Sq,Hkv,G,hd)
    k, v = _pad_seq(k, 0, pk), _pad_seq(v, 0, pk)
    nq, nk = (sq + pq) // cq, (skv_real + pk) // ck
    dev = q.device
    qpos_base = torch.arange(cq, device=dev)
    kpos_base = torch.arange(ck, device=dev)

    def kv_step(m, den, acc, qblk, kblk, vblk, qpos, kpos):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qblk.float(),
                         kblk.float()) * scale               # (B,Hkv,G,cq,ck)
        # additive (cq, ck) mask, added pre-broadcast
        mask = (kpos[None, :] < skv_real).expand(cq, ck)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = s + torch.where(mask, 0.0, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den_new = den * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vblk.float())
        return m_new, den_new, acc * corr[..., None] + pv

    def q_step(qblk, k, v, qi):
        qpos = q_offset + qi * cq + qpos_base                 # (cq,)
        m = torch.full((b, hkv, g, cq), NEG_INF, device=dev)
        den = torch.zeros((b, hkv, g, cq), device=dev)
        acc = torch.zeros((b, hkv, g, cq, hd), device=dev)
        for ki in range(nk):
            sl = slice(ki * ck, (ki + 1) * ck)
            m, den, acc = remat_chunk(kv_step, m, den, acc, qblk,
                                      k[:, sl], v[:, sl], qpos,
                                      ki * ck + kpos_base)
        out = acc / torch.clamp(den, min=1e-30)[..., None]  # (B,Hkv,G,cq,hd)
        return out.movedim(3, 1)                              # (B,cq,Hkv,G,hd)

    outs = [remat_chunk(q_step, q[:, qi * cq:(qi + 1) * cq], k, v, qi)
            for qi in range(nq)]
    out = torch.cat(outs, dim=1).reshape(b, sq + pq, h, hd)
    return out[:, :sq]                                        # (B,Sq,H,hd)


def windowed_attention(q, k, v, *, window: int, chunk_q: int, scale: float):
    """Local/SWA attention with per-q-chunk KV slicing: O(S·window) FLOPs.

    The q chunk starting at t attends keys in [t - window, t + cq); KV is
    padded on the left by ``window`` so every slice has one size.
    """
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    cq = min(chunk_q, sq)
    pq = (-sq) % cq
    nq = (sq + pq) // cq
    span = window + cq
    q = _fold_gqa(_pad_seq(q, 0, pq), hkv)
    kp, vp = _pad_seq(k, window, pq), _pad_seq(v, window, pq)
    dev = q.device
    qpos_base = torch.arange(cq, device=dev)
    kpos_base = torch.arange(span, device=dev)

    def q_step(qblk, kblk, vblk, start):
        qpos = start + qpos_base                              # unpadded
        kpos = start + kpos_base - window
        s = torch.einsum("bqhgd,bkhd->bhgqk", qblk.float(),
                         kblk.float()) * scale
        mask = (kpos[None, :] <= qpos[:, None]) \
            & (kpos[None, :] > qpos[:, None] - window) \
            & (kpos[None, :] >= 0) & (kpos[None, :] < sq)
        s = s + torch.where(mask, 0.0, NEG_INF)               # pre-broadcast
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bhgqd", p, vblk.float())
        return out.movedim(3, 1)                              # (B,cq,Hkv,G,hd)

    outs = []
    for qi in range(nq):
        start = qi * cq                 # kv slice start in padded coords
        outs.append(remat_chunk(q_step, q[:, start:start + cq],
                                kp[:, start:start + span],
                                vp[:, start:start + span], start))
    return torch.cat(outs, dim=1).reshape(b, sq + pq, h, hd)[:, :sq]


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

    if cfg.use_kernels:
        out = kops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                   scale=scale)
    elif window > 0:
        out = windowed_attention(q, k, v, window=window,
                                 chunk_q=cfg.attn_q_chunk, scale=scale)
    else:
        out = blocked_attention(q, k, v, causal=cfg.causal, window=0,
                                q_offset=0, chunk_q=cfg.attn_q_chunk,
                                chunk_kv=cfg.attn_kv_chunk, scale=scale)
    out = out.reshape(b, s, h * hd).to(cdt(cfg))
    return linear(p.wo, out, cfg), KVCache(k, v)
