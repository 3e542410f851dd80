"""Model assembly (the port's ``repro.models.model``): the layer stack,
its caches, prefill and decode.

The reference stacks each homogeneous layer group and runs it with
``lax.scan``; the port keeps one module per layer (``LM.layers``, in the
order of ``cfg.pattern()``, which is the reference's group order) and
runs them as a Python loop. Caches are a list with one entry per layer in
place of the reference's stacked ``repeats`` dim: a ``KVCache`` for an
attention layer, an ``RGLRUState`` for an RG-LRU layer.

Training (``loss_fn``, ``mode="train"``) is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import _device
from repro_torch.models import recurrent as rec
from repro_torch.models.attention import AttnMixer, KVCache, attn_block
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, Embed, Linear, Norm, apply_mlp, \
    apply_norm, cdt, embed_tokens, unembed
from repro_torch.models.schema import ATTN_KINDS, check_ported


class Block(nn.Module):
    """One layer: ``mixer`` and, for attention kinds with d_ff > 0,
    ``mlp`` (RG-LRU blocks carry no MLP, as in the reference)."""

    def __init__(self, cfg: ModelConfig, kind: str, device):
        super().__init__()
        self.kind = kind
        if kind == "rglru":
            self.mixer = rec.RGLRUMixer(cfg, device)
        else:
            self.mixer = AttnMixer(cfg, device)
        self.mlp = (MLP(cfg, device)
                    if cfg.d_ff > 0 and kind in ATTN_KINDS else None)


class LM(nn.Module):
    """``embed``, ``layers``, ``final_norm`` and, unless the embedding is
    tied, ``lm_head``. Parameters are left uninitialised: fill them with
    ``convert.params_from_reference`` (or build with ``init_model``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        device = _device.resolve(device)
        self.embed = Embed(cfg, device)
        self.layers = nn.ModuleList(Block(cfg, kind, device)
                                    for kind in cfg.pattern())
        self.final_norm = Norm(cfg.d_model, cfg, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else Linear(cfg.d_model, cfg.vocab_size, cfg, device))

    @property
    def device(self) -> torch.device:
        return self.embed.w.device


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _attn_cache_init(cfg: ModelConfig, kind: str, b: int, cap: int, device):
    window = cfg.window if kind in ("swa", "local") else 0
    c = min(window, cap) if window else cap
    shape = (b, c, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=cdt(cfg), device=device),
                   torch.zeros(shape, dtype=cdt(cfg), device=device))


def init_cache(cfg: ModelConfig, batch: int, cap: int, device=None):
    """Empty decode caches, one per layer."""
    device = _device.resolve(device)
    return [rec.rglru_state_init(batch, cfg.lru_d, device) if kind == "rglru"
            else _attn_cache_init(cfg, kind, batch, cap, device)
            for kind in cfg.pattern()]


def _prefill_attn_cache(cfg: ModelConfig, kind: str, kv: KVCache,
                        pad_to: int = 0) -> KVCache:
    """Turn prefill-computed (k, v) into a decode cache: a window cache
    keeps the last ``window`` entries rolled so slot i holds a position
    = i (mod window), or pads a short prefill to the window; a
    full-attention cache pads to ``pad_to`` capacity."""
    window = cfg.window if kind in ("swa", "local") else 0
    k, v = kv.k, kv.v
    s = k.shape[1]
    if window and s > window:
        shift = s % window
        k = torch.roll(k[:, -window:], shift, dims=1)
        v = torch.roll(v[:, -window:], shift, dims=1)
    elif window and s < window:
        # ring decode indexes slots mod window: pad short prefills to the
        # full window (slot i == position i while the buffer first fills)
        k = F.pad(k, (0, 0, 0, 0, 0, window - s))
        v = F.pad(v, (0, 0, 0, 0, 0, window - s))
    elif not window and pad_to > s:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_to - s))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_to - s))
    return KVCache(k.to(cdt(cfg)).contiguous(), v.to(cdt(cfg)).contiguous())


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_block(block: Block, x, cfg: ModelConfig, cache, positions,
                 cache_pos, mode: str, prefill_pad: int = 0):
    """One layer. Returns (x, new_cache)."""
    if block.kind == "rglru":
        out, c_new = rec.rglru_block(block.mixer, x, cfg, cache)
    else:
        out, c_new = attn_block(block.mixer, x, cfg, block.kind,
                                positions=positions, cache=cache,
                                cache_pos=cache_pos)
        if mode == "prefill":
            c_new = _prefill_attn_cache(cfg, block.kind, c_new, prefill_pad)
    x = x + out
    if block.mlp is not None:
        x = x + apply_mlp(block.mlp, x, cfg)
    return x, c_new


def forward(model: LM, cfg: ModelConfig, *, tokens, positions=None,
            cache: Optional[List] = None, cache_pos: Optional[int] = None,
            mode: str = "prefill", prefill_pad: int = 0):
    """Run the stack. Returns (x_final, new_cache).

    mode: prefill (produce caches) | decode (consume them).
    """
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"mode={mode!r}: the port serves (prefill, decode); training "
            "is not ported yet (ROADMAP.md)")
    x = embed_tokens(model.embed, tokens, cfg)
    if positions is None:
        base = torch.arange(x.shape[1], device=x.device)[None, :]
        if mode == "decode":
            base = base + cache_pos
        positions = base.expand(x.shape[0], -1)
    new_cache = []
    for li, block in enumerate(model.layers):
        ci = cache[li] if cache is not None else None
        x, c_new = _apply_block(block, x, cfg, ci, positions, cache_pos,
                                mode, prefill_pad)
        new_cache.append(c_new)
    x = apply_norm(model.final_norm, x, cfg)
    return x, new_cache


def lm_logits(model: LM, cfg: ModelConfig, x):
    return unembed(model, x, cfg)


def prefill(model: LM, cfg: ModelConfig, *, tokens, positions=None,
            pad_to: int = 0):
    """Returns (last_token_logits (B, V), cache)."""
    x, cache = forward(model, cfg, tokens=tokens, positions=positions,
                       mode="prefill", prefill_pad=pad_to)
    return lm_logits(model, cfg, x[:, -1:, :])[:, 0, :], cache


def decode_step(model: LM, cfg: ModelConfig, cache, token, pos: int):
    """One decode step. token: (B, 1) int; pos: the write slot. Returns
    (logits (B, V), new_cache)."""
    x, new_cache = forward(model, cfg, tokens=token, cache=cache,
                           cache_pos=pos, mode="decode")
    return lm_logits(model, cfg, x)[:, 0, :], new_cache
