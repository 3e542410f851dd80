"""The model-side wrapper of the attention kernel (the port's
``repro.kernels.ops``): the (B, S, H, hd) <-> (BH, S, hd) head fold
around ``flash_attention``. The RG-LRU scan needs no fold: the model
calls ``kernels.rglru_scan`` directly."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa


def fold_heads(q, k, v):
    """q: (B, S, H, hd); k, v: (B, Skv, Hkv, hd) -> contiguous (B*H, S, hd)
    and (B*Hkv, Skv, hd). q heads are grouped (B, Hkv, G), so that q row
    ``bh`` reads kv row ``bh // G``."""
    bsz, sq, h, hd = q.shape
    _, skv, hkv, _ = k.shape
    qf = q.permute(0, 2, 1, 3).reshape(bsz * h, sq, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(bsz * hkv, skv, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(bsz * hkv, skv, hd).contiguous()
    return qf, kf, vf


def unfold_heads(o, bsz: int):
    """(B*H, S, hd) -> (B, S, H, hd)."""
    bh, s, hd = o.shape
    return o.reshape(bsz, bh // bsz, s, hd).permute(0, 2, 1, 3)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float = 0.0):
    """q: (B, S, H, hd); k, v: (B, Skv, Hkv, hd) -> (B, S, H, hd)."""
    o = _fa.flash_attention(*fold_heads(q, k, v), causal=causal,
                            window=window, scale=scale)
    return unfold_heads(o, q.shape[0])
