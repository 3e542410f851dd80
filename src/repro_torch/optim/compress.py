"""Int8 gradient compression with error feedback (the port's
``repro.optim.compress``).

Per-tensor symmetric int8: scale = max|g| / 127 in f32, q = round(g /
scale) clipped to [-127, 127] (``torch.round`` rounds half to even, as
``jnp.round`` does), and the quantization error is carried in an f32
accumulator and added back on the next step (error feedback). The wire
format is the int8 payload plus the f32 scale.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class CompressState(NamedTuple):
    error: Dict[str, torch.Tensor]     # residual per tensor, f32


def init(params: Dict[str, torch.Tensor]) -> CompressState:
    return CompressState({n: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
                          for n, p in params.items()})


def _quantize(g):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads: Dict[str, torch.Tensor], state: CompressState
                   ) -> Tuple[dict, CompressState, dict]:
    """Returns (decompressed grads as the optimizer sees them, the new
    error state, wire stats). ``grads`` and ``state.error`` share keys."""
    deq, err = {}, {}
    wire_bytes = raw_bytes = 0
    for n, g in grads.items():
        g = g.float() + state.error[n]
        q, scale = _quantize(g)
        deq[n] = _dequantize(q, scale)
        err[n] = g - deq[n]
        wire_bytes += q.numel()                   # int8: 1 byte/elem
        raw_bytes += g.numel() * 4
    return deq, CompressState(err), {
        "wire_bytes": wire_bytes, "raw_bytes": raw_bytes,
        "ratio": raw_bytes / max(wire_bytes, 1)}
