"""Griffin's RG-LRU recurrent block (the RG-LRU part of the port's
``repro.models.recurrent``; mLSTM and sLSTM are not ported yet).

Prefill (S > 1) runs the recurrence through the CUDA kernel
``rglru_scan`` when ``cfg.use_kernels`` is set (its plain version on CPU
tensors), and through ``linear_scan`` otherwise. A decode step (S = 1) is
the plain elementwise update, as in the reference. States live in the
layer cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import rglru_scan as rg
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Linear, Norm, apply_norm, cdt, \
    linear, param

C_LRU = 8.0


# ---------------------------------------------------------------------------
# causal conv1d (width 4) with decode state
# ---------------------------------------------------------------------------

class ConvState(NamedTuple):
    buf: torch.Tensor                   # (B, W-1, D) trailing inputs, f32


class Conv(nn.Module):
    """Depthwise conv: ``w`` (W, D), ``b`` (D,)."""

    def __init__(self, width: int, d: int, cfg: ModelConfig, device):
        super().__init__()
        self.w = param((width, d), cfg, device)
        self.b = param((d,), cfg, device)


def causal_conv(p: Conv, x, state: Optional[ConvState]):
    """Depthwise causal conv. x: (B,S,D). Returns (y, new_state). Without
    a state the input is padded with width-1 zeros on the left."""
    width = p.w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.buf.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * p.w[0].to(x.dtype)
    for i in range(1, width):
        y = y + xp[:, i:i + s] * p.w[i].to(x.dtype)
    y = y + p.b.to(x.dtype)
    return y, ConvState(xp[:, -(width - 1):].float())


def conv_state_init(b: int, d: int, device):
    return ConvState(torch.zeros((b, 3, d), dtype=torch.float32,
                                 device=device))


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------

class RGLRUState(NamedTuple):
    h: torch.Tensor                     # (B, dr) f32
    conv: ConvState


def rglru_state_init(b: int, dr: int, device):
    return RGLRUState(torch.zeros((b, dr), dtype=torch.float32,
                                  device=device),
                      conv_state_init(b, dr, device))


class LRU(nn.Module):
    """``lam`` (Λ), ``wa``/``ba`` (recurrence gate), ``wi``/``bi`` (input
    gate)."""

    def __init__(self, dr: int, cfg: ModelConfig, device):
        super().__init__()
        self.lam = param((dr,), cfg, device)
        self.wa = Linear(dr, dr, cfg, device)
        self.ba = param((dr,), cfg, device)
        self.wi = Linear(dr, dr, cfg, device)
        self.bi = param((dr,), cfg, device)


class RGLRUMixer(nn.Module):
    """x -> [conv4 -> RG-LRU] * gelu(gate) -> out: ``norm``, ``wx``,
    ``wg``, ``conv``, ``lru``, ``wo`` as in the reference."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dr = cfg.d_model, cfg.lru_d
        self.norm = Norm(d, cfg, device)
        self.wx = Linear(d, dr, cfg, device)
        self.wg = Linear(d, dr, cfg, device)
        self.conv = Conv(cfg.conv_width, dr, cfg, device)
        self.lru = LRU(dr, cfg, device)
        self.wo = Linear(dr, d, cfg, device)


def rglru_block(p: RGLRUMixer, x, cfg: ModelConfig,
                state: Optional[RGLRUState]):
    """x: (B,S,d). Returns (out, new_state)."""
    b, s, _ = x.shape
    dr = cfg.lru_d
    hx = apply_norm(p.norm, x, cfg)
    xr = linear(p.wx, hx, cfg)                                # (B,S,dr)
    xg = linear(p.wg, hx, cfg)
    xr, conv_state = causal_conv(p.conv, xr,
                                 state.conv if state is not None else None)
    xr32 = xr.float()
    lru = p.lru
    r = torch.sigmoid(xr32 @ lru.wa.w.float() + lru.ba.float())  # recurrence
    i = torch.sigmoid(xr32 @ lru.wi.w.float() + lru.bi.float())  # input gate
    log_a = C_LRU * r * F.logsigmoid(lru.lam.float())
    a = torch.exp(log_a)                                      # in (0, 1)
    gx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xr32)

    h0 = (state.h if state is not None
          else torch.zeros((b, dr), dtype=torch.float32, device=x.device))
    if cfg.use_kernels and s > 1:
        hs, h_f = rg.rglru_scan(a.contiguous(), gx.contiguous(),
                                h0.contiguous())
    else:
        hs, h_f = linear_scan(a, gx, h0)
    # jax.nn.gelu defaults to the tanh approximation
    out = hs.to(cdt(cfg)) * F.gelu(xg, approximate="tanh")
    out = linear(p.wo, out, cfg)
    return out, RGLRUState(h_f, conv_state)


def linear_scan(a, b_in, h0):
    """h_t = a_t * h_{t-1} + b_t as a log-depth (Hillis-Steele) scan, the
    plain counterpart of the reference's associative scan. a, b: (B,S,D);
    h0: (B,D). Returns (h (B,S,D), h_final (B,D))."""
    # fold h0 into the first element: b_1' = a_1 * h0 + b_1
    hh = b_in.clone()
    hh[:, 0] = hh[:, 0] + a[:, 0] * h0
    aa = a
    shift = 1
    while shift < a.shape[1]:
        # combine(x, y) = (a1 * a2, a2 * b1 + b2) with x shift steps back
        hh = torch.cat([hh[:, :shift], aa[:, shift:] * hh[:, :-shift]
                        + hh[:, shift:]], dim=1)
        aa = torch.cat([aa[:, :shift], aa[:, shift:] * aa[:, :-shift]],
                       dim=1)
        shift *= 2
    return hh, hh[:, -1]
