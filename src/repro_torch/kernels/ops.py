"""The public wrappers of the port's kernels (the port's
``repro.kernels.ops``): ``flash_attention`` with the (B, S, H, hd) <->
(BH, S, hd) head fold, and ``rglru_scan`` and ``pe_execute`` as the
kernel modules give them (each launches its CUDA kernel on a CUDA tensor
and runs its plain version on a CPU one). Callers may import the kernel
modules directly; the model and the stepper do."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import pe_simd as _pe
from repro_torch.kernels import rglru_scan as _rg


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


def rglru_scan(a, b, h0):
    """(B, S, D) recurrence h_t = a_t * h_{t-1} + b_t from h0 (B, D) ->
    (h (B, S, D), h_final (B, D)); see ``kernels/rglru_scan.py``."""
    return _rg.rglru_scan(a, b, h0)


def pe_execute(op, imm, a, b, ops_present=None):
    """The G-GPU execute stage: op, imm (W, 1), a, b (W, L) int32 ->
    (W, L) int32; see ``kernels/pe_simd.py``."""
    return _pe.pe_execute(op, imm, a, b, ops_present)
