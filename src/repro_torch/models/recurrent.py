"""Recurrent mixers (the port's ``repro.models.recurrent``): xLSTM's
mLSTM and sLSTM, and Griffin's RG-LRU.

  * mLSTM: the chunkwise-parallel form, quadratic inside a chunk of
    ``cfg.mlstm_chunk`` steps and a (hd, hd) matrix memory per head
    across chunks, with log-space stabilisers. S is padded to a chunk
    multiple; a decode step is one chunk of 1.
  * sLSTM: strictly sequential (h_{t-1} feeds the gates), a Python loop
    over S in blocks of isqrt(S) steps; S is padded with zero inputs to
    a whole number of blocks, and the final state is the one after the
    padded steps, as in the reference.
  * RG-LRU: prefill (S > 1) runs the recurrence through the CUDA kernel
    ``rglru_scan`` when ``cfg.use_kernels`` is set (its plain version on
    CPU tensors), and through ``linear_scan`` otherwise; a decode step
    (S = 1) is the plain elementwise update.

The mLSTM and sLSTM are torch operations, as the reference computes them
in plain XLA (no Pallas kernel). Under autograd each mLSTM chunk and each
sLSTM block is recomputed in the backward (the reference's
``jax.checkpoint`` on them). States live in the layer cache.

In a sharded step (``sharding.ctx.sharded``: training, and the serving
steps given rules) each block computes this rank's "model" part of its
"ffn" widths (the "acts_ffn" split), as the reference's parameter specs
lay them out (``*_block_tp``):
  * RG-LRU: ``wx`` and ``wg`` column-parallel on the whole sequence, the
    conv, Λ and the scan on the rank's dr / tp channels (the
    ``rglru_scan`` kernel at (B, S, dr / tp)); ``lru.wa`` and ``lru.wi``
    hold rows, so their partial sums are reduce-scattered to the rank's
    channels before the gates; ``wo`` row-parallel.
  * mLSTM: ``wup``'s fused x|gate columns paired (``ctx.swiglu_pairs``),
    the conv on the rank's channels, ``wq``/``wk``/``wv``/``wif``
    row-parallel: their partial sums reduce-scattered to the rank's
    heads where the heads divide the axis, all-reduced otherwise (the
    matrix memory then runs whole on every rank, and each rank keeps
    its channels of the head-normed output); ``wdown`` row-parallel.
  * sLSTM: ``wg`` column-parallel and gathered, since the recurrence
    couples heads: ``slstm_step`` splits (B, H, 4 hd) reshaped to (B, 4
    d) into i|f|z|o, so each gate of a channel reads other heads'
    h_{t-1}, and a per-head split would need a collective every step.
    The recurrence runs whole on every rank; ``wo`` column-parallel.
A block whose weights the rules leave unsplit runs whole on every rank
(``ctx.whole_block``). In a serving step the recurrent states of rank <
4 stay whole over "model" (a rank's new channels gathered), and the
mLSTM's (B, H, hd, hd) memory is this rank's block by the "kv_cache"
rule (``rules.cache_shardings``): its first hd dim where hd divides the
axis, which the decode step's ``q @ C`` reads as a partial sum over
the ranks (all-reduced) and its update writes from the rank's slice of
k.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import rglru_scan as rg
from repro_torch.models.attention import remat_chunk
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import ONE, shard_hint
from repro_torch.models.layers import Linear, Norm, apply_norm, cdt, \
    head_rms, linear, param, rms_head_norm, row_out, seq_norm

LOG_EPS = -30.0
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
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    c: torch.Tensor                     # (B, H, hd, hd) memory (m-scaled)
    n: torch.Tensor                     # (B, H, hd)
    m: torch.Tensor                     # (B, H) log-space stabiliser
    conv: ConvState


def mlstm_state_init(b: int, h: int, hd: int, de: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(torch.zeros((b, h, hd, hd), **f32),
                      torch.zeros((b, h, hd), **f32),
                      torch.full((b, h), LOG_EPS, **f32),
                      conv_state_init(b, de, device))


class MLSTMMixer(nn.Module):
    """``norm``, ``wup`` (fused x|gate), ``conv``, ``wq``, ``wk``, ``wv``,
    ``wif`` (i/f gate pre-activations), ``onorm``, ``wdown``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        de = 2 * d                      # expansion 2 (xLSTM paper)
        self.norm = Norm(d, cfg, device)
        self.wup = Linear(d, 2 * de, cfg, device)
        self.conv = Conv(cfg.conv_width, de, cfg, device)
        self.wq = Linear(de, de, cfg, device)
        self.wk = Linear(de, de, cfg, device)
        self.wv = Linear(de, de, cfg, device)
        self.wif = Linear(de, 2 * h, cfg, device)
        self.onorm = Norm(de, cfg, device, bias=False)
        self.wdown = Linear(de, d, cfg, device)


def _mlstm_chunk(carry, inp, ax=ONE):
    """One chunk of the chunkwise-parallel stabilised mLSTM.

    carry: (C, n, m) with C (B,H,hd,hd); inp: q, k, v (B,c,H,hd) with k
    pre-scaled by hd^-0.5, logi/logf (B,c,H). All f32. With ``ax`` of
    more than one rank, C is this rank's block of its first hd dim: the
    product ``q @ C`` is summed over ``ax`` and the update writes the
    rank's rows from its slice of k.
    """
    C_p, n_p, m_p = carry
    q, k, v, logi, logf = inp
    c = q.shape[1]
    fc = torch.cumsum(logf, dim=1)                            # (B,c,H)
    ftot = fc[:, -1]                                          # (B,H)
    g = torch.cummax(logi - fc, dim=1).values                 # (B,c,H)
    m_t = fc + torch.maximum(m_p[:, None], g)                 # (B,c,H)

    # decay matrix D[t,s] = exp(F_t - F_s + logi_s - m_t), s <= t
    log_d = (fc[:, :, None] - fc[:, None, :] + logi[:, None, :]
             - m_t[:, :, None])                               # (B,t,s,H)
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(tri[None, :, :, None], torch.exp(log_d), 0.0)

    s_qk = torch.einsum("bthd,bshd->btsh", q, k)              # (B,t,s,H)
    intra = torch.einsum("btsh,bshd->bthd", s_qk * dmat, v)
    w_inter = torch.exp(fc + m_p[:, None] - m_t)              # (B,c,H)
    if ax.n == 1:
        inter = torch.einsum("bthd,bhde->bthe", q, C_p)
    else:
        inter = ctx.all_reduce(torch.einsum(
            "bthd,bhde->bthe", ctx.local_slice(q, 3, ax), C_p), ax)
    inter = inter * w_inter[..., None]
    n_t = (w_inter[..., None] * n_p[:, None]
           + torch.einsum("btsh,bshd->bthd", dmat, k))
    qn = torch.einsum("bthd,bthd->bth", q, n_t).abs()
    denom = torch.maximum(qn, torch.exp(-m_t))
    h = (intra + inter) / denom[..., None]                    # (B,c,H,hd)

    # chunk-end state
    m_new = m_t[:, -1]                                        # (B,H)
    w_c = torch.exp(ftot[:, None] - fc + logi - m_new[:, None])  # (B,s,H)
    decay = torch.exp(ftot + m_p - m_new)
    kc = k if ax.n == 1 else ctx.local_slice(k, 3, ax)
    C_new = (decay[..., None, None] * C_p
             + torch.einsum("bsh,bshd,bshe->bhde", w_c, kc, v))
    n_new = (decay[..., None] * n_p
             + torch.einsum("bsh,bshd->bhd", w_c, k))
    return (C_new, n_new, m_new), h


def mlstm_scan(q, k, v, logi, logf, state: MLSTMState, chunk: int,
               ax=ONE):
    """q, k, v: (B,S,H,hd) f32; logi/logf: (B,S,H) f32. Returns (h,
    (C, n, m)). ``ax``: C split over it (``_mlstm_chunk``).

    S is padded to a chunk multiple with the i-gate at 2·LOG_EPS (no
    state contribution) and the f-gate at 1 (state kept); the padded
    outputs are sliced off."""
    s = q.shape[1]
    ck = min(chunk, s)
    pad = (-s) % ck
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=2 * LOG_EPS)
        logf = F.pad(logf, (0, 0, 0, pad))
    carry = (state.c, state.n, state.m)
    step = _mlstm_chunk if ax.n == 1 else functools.partial(_mlstm_chunk,
                                                            ax=ax)
    hs = []
    for i in range(0, s + pad, ck):
        sl = slice(i, i + ck)
        carry, h = remat_chunk(step, carry,
                               (q[:, sl], k[:, sl], v[:, sl], logi[:, sl],
                                logf[:, sl]))
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :s], carry


def mlstm_block(p: MLSTMMixer, x, cfg: ModelConfig,
                state: Optional[MLSTMState]):
    """The mLSTM block. x: (B,S,d). Returns (out, new_state)."""
    b, s, d = x.shape
    de = 2 * d
    h = cfg.n_heads
    hd = de // h
    hx = apply_norm(p.norm, x, cfg)
    u, g = linear(p.wup, hx, cfg).chunk(2, dim=-1)            # (B,S,de) x2
    u, conv_state = causal_conv(p.conv, u,
                                state.conv if state is not None else None)
    u = F.silu(u)
    q = linear(p.wq, u, cfg).reshape(b, s, h, hd).float()
    k = linear(p.wk, u, cfg).reshape(b, s, h, hd).float()
    v = linear(p.wv, u, cfg).reshape(b, s, h, hd).float()
    k = k * hd ** -0.5
    gates = linear(p.wif, u, cfg).float()                     # (B,S,2H)
    logi, f_pre = gates[..., :h], gates[..., h:]
    # log sigmoid: the reference's -softplus(-f), which jax computes
    # without torch's softplus switch to the identity above 20
    logf = F.logsigmoid(f_pre)

    st = state if state is not None else mlstm_state_init(b, h, hd, de,
                                                          x.device)
    hs, (c_f, n_f, m_f) = mlstm_scan(q, k, v, logi, logf, st,
                                     cfg.mlstm_chunk)
    hs = rms_head_norm(p.onorm.scale.reshape(h, hd), hs.to(cdt(cfg)))
    out = hs.reshape(b, s, de) * F.silu(g)
    return linear(p.wdown, out, cfg), MLSTMState(c_f, n_f, m_f, conv_state)


def mlstm_block_tp(p: MLSTMMixer, x, cfg: ModelConfig,
                   state: Optional[MLSTMState], keep_state: bool):
    """The mLSTM block of this rank's part ``x`` of the residual stream in
    a sharded step (module doc): (this rank's part of the output, the
    new state laid out for the cache when ``keep_state``, else None).
    With a ``state`` (decode) q, k, v and the gates are whole and the
    memory is the cache's block."""
    st = ctx.sharded()
    ax = st.model
    if not (ctx.split_dim(p.wup.w) == 1 and ctx.split_dim(p.wq.w) == 0
            and ctx.split_dim(p.wdown.w) == 0):
        return _whole(p, mlstm_block, x, cfg, state, keep_state)
    de = 2 * cfg.d_model
    h = cfg.n_heads
    hd = de // h
    dt = cdt(cfg)
    hcol = ctx.whole_seq(apply_norm(seq_norm(p.norm), x, cfg),
                         grad_sum=True)
    b, s, _ = hcol.shape
    u, g = (hcol @ ctx.swiglu_pairs(p.wup.w.to(dt), ax)).chunk(2, dim=-1)
    u, conv_state = causal_conv(p.conv, u, None if state is None else
                                ConvState(ctx.local_slice(state.conv.buf,
                                                          2, ax)))
    u = F.silu(u)
    # the row-parallel products' partial sums: to this rank's heads where
    # they divide the axis (train and prefill), else whole
    local = state is None and h % ax.n == 0
    nh = h // ax.n if local else h

    def heads(lin, lead):
        part = linear(lin, u, cfg).reshape(b, s, *lead)
        return (ctx.scatter_sum(part, part.ndim - 1, ax) if local
                else ctx.reduce_sum(part, ax)).float()
    q, k, v = (heads(lin, (h * hd,)).reshape(b, s, nh, hd)
               for lin in (p.wq, p.wk, p.wv))
    gates = heads(p.wif, (2, h))
    lay, cax = None, ONE
    if state is None:
        mem = mlstm_state_init(b, nh, hd, 0, x.device)
    else:
        lay = getattr(state.c, "model_dim", None)
        cax = ax if lay == 2 else ONE
        mem = state._replace(c=state.c if lay == 2
                             else ctx.whole_leaf(state.c))
    hs, (c_f, n_f, m_f) = mlstm_scan(q, k * hd ** -0.5, v, gates[:, :, 0],
                                     F.logsigmoid(gates[:, :, 1]), mem,
                                     cfg.mlstm_chunk, cax)
    hs = hs.to(dt)
    if local:
        y = rms_head_norm(p.onorm.scale.reshape(nh, hd), hs)
    else:
        # whole heads: this rank's channels of the normed output
        y = ctx.split(head_rms(hs).reshape(b, s, de), 2, ax)
        y = (y * p.onorm.scale.float()).to(dt)
    out = y.reshape(b, s, -1) * F.silu(g)
    out = row_out(out @ p.wdown.w.to(dt), p.wdown.b, cfg)
    if not keep_state:
        return out, None
    if local:
        c_f, n_f, m_f = (ctx.all_gather(t, 1, ax) for t in (c_f, n_f, m_f))
    if state is None:
        lay = st.model_dim("kv_cache", tuple(c_f.shape))
    if cax.n > 1:
        c_f.model_dim = lay             # the cache's block, updated
    else:
        c_f = ctx.leaf_part(c_f, lay)
    return out, MLSTMState(c_f, n_f, m_f, ConvState(
        ctx.all_gather(conv_state.buf, 2, ax)))


def _whole(p, block, x, cfg: ModelConfig, state, keep_state: bool):
    """``block`` run whole on every rank (``ctx.whole_block``), where the
    rules leave its weights unsplit: its state whole, an mLSTM memory
    gathered from the cache's block and cut back to it."""
    lay = None
    if isinstance(state, MLSTMState):
        lay = getattr(state.c, "model_dim", None)
        state = state._replace(c=ctx.whole_leaf(state.c))
    out, new = ctx.whole_block(p, lambda xw: block(p, xw, cfg, state), x)
    if not keep_state:
        return out, None
    if isinstance(new, MLSTMState):
        if state is None:
            lay = ctx.sharded().model_dim("kv_cache", tuple(new.c.shape))
        new = new._replace(c=ctx.leaf_part(new.c, lay))
    return out, new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: torch.Tensor                     # (B, d) f32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def slstm_state_init(b: int, d: int, device):
    z = torch.zeros((b, d), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, torch.full((b, d), LOG_EPS,
                                          dtype=torch.float32,
                                          device=device))


class SLSTMMixer(nn.Module):
    """``norm``, ``wg`` (i|f|z|o of x_t), ``rg`` (H, hd, 4hd), the
    per-head recurrent weights, ``bg``, ``wo``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        hd = d // h
        self.norm = Norm(d, cfg, device)
        self.wg = Linear(d, 4 * d, cfg, device)
        self.rg = param((h, hd, 4 * hd), cfg, device)
        self.bg = param((4 * d,), cfg, device)
        self.wo = Linear(d, d, cfg, device)


def slstm_step(carry, g_t, rg):
    """One sLSTM step: carry (c, n, h, m), each (B, d) f32; g_t (B, 4d)
    the input's gate pre-activations; rg (H, hd, 4hd) f32."""
    c, n, hprev, m = carry
    b, d = c.shape
    h, hd = rg.shape[:2]
    rec = torch.einsum("bhd,hde->bhe", hprev.reshape(b, h, hd),
                       rg).reshape(b, 4 * d)
    gi, gf, gz, go = (g_t + rec).chunk(4, dim=-1)
    m_new = torch.maximum(gf + m, gi)                         # exp f-gate
    ip = torch.exp(gi - m_new)
    fp = torch.exp(gf + m - m_new)
    c_new = fp * c + ip * torch.tanh(gz)
    n_new = fp * n + ip
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_steps(carry, g_blk, rg):
    """``slstm_step`` over the steps of g_blk (B, blk, 4d). Returns (the
    carry, h of each step (B, blk, d))."""
    hs = []
    for t in range(g_blk.shape[1]):
        carry = slstm_step(carry, g_blk[:, t], rg)
        hs.append(carry[2])
    return carry, torch.stack(hs, dim=1)


def slstm_block(p: SLSTMMixer, x, cfg: ModelConfig,
                state: Optional[SLSTMState]):
    """The sequential sLSTM with a per-head block-diagonal recurrence.
    x: (B,S,d). Returns (out, new_state)."""
    hx = apply_norm(p.norm, x, cfg)
    gx = (linear(p.wg, hx, cfg) + p.bg.to(cdt(cfg))).float()  # (B,S,4d)
    hs, new = _slstm_run(p, gx, cfg, state)
    return linear(p.wo, hs, cfg), new


def _slstm_run(p: SLSTMMixer, gx, cfg: ModelConfig,
               state: Optional[SLSTMState]):
    """The recurrence over the gates' input pre-activations gx (B,S,4d)
    f32: (h (B,S,d) in the compute dtype, the new state)."""
    b, s = gx.shape[:2]
    d = gx.shape[2] // 4
    st = state if state is not None else slstm_state_init(b, d, gx.device)
    rg = p.rg.float()
    # blocks of isqrt(S) steps (the reference's two-level checkpoint);
    # the padded steps run too and move the final state
    blk = max(1, int(s ** 0.5))
    nb = -(-s // blk)
    gx = F.pad(gx, (0, 0, 0, nb * blk - s))
    carry, hs = tuple(st), []
    for j in range(0, nb * blk, blk):
        carry, h = remat_chunk(_slstm_steps, carry, gx[:, j:j + blk], rg)
        hs.append(h)
    hs = torch.cat(hs, dim=1)[:, :s].to(cdt(cfg))             # (B,S,d)
    return hs, SLSTMState(*carry)


def slstm_block_tp(p: SLSTMMixer, x, cfg: ModelConfig,
                   state: Optional[SLSTMState], keep_state: bool):
    """The sLSTM block of this rank's part ``x`` of the residual stream in
    a sharded step (module doc): ``wg``'s columns on the whole sequence,
    gathered for the recurrence, which runs whole on every rank, and
    ``wo``'s columns gathered to the output."""
    ax = ctx.sharded().model
    if ctx.split_dim(p.wg.w) != 1 or ctx.split_dim(p.wo.w) != 1:
        return _whole(p, slstm_block, x, cfg, state, keep_state)
    dt = cdt(cfg)
    hcol = ctx.whole_seq(apply_norm(seq_norm(p.norm), x, cfg),
                         grad_sum=True)
    gx = ctx.gather((linear(p.wg, hcol, cfg) + p.bg.to(dt)).float(), 2, ax,
                    False)
    hs, new = _slstm_run(p, gx, cfg, state)
    out = ctx.gather(ctx.copy(hs, ax) @ p.wo.w.to(dt), 2, ax, False)
    return shard_hint(out, "acts", "whole"), new if keep_state else None


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
    h0 = (state.h if state is not None
          else torch.zeros((b, dr), dtype=torch.float32, device=x.device))
    hs, h_f = _rglru_scan(cfg, lru.lam, r, i, xr32, h0)
    # jax.nn.gelu defaults to the tanh approximation
    out = hs.to(cdt(cfg)) * F.gelu(xg, approximate="tanh")
    out = linear(p.wo, out, cfg)
    return out, RGLRUState(h_f, conv_state)


def _rglru_scan(cfg: ModelConfig, lam, r, i, xr32, h0):
    """The RG-LRU's recurrence from its gates r, i and input xr32 (B,S,D)
    f32 over channels whose Λ is ``lam``: through ``rglru_scan`` when
    ``cfg.use_kernels`` is set and S > 1, else ``linear_scan``. Returns
    (h (B,S,D) at the "acts_ffn" hint, h_final (B,D))."""
    log_a = C_LRU * r * F.logsigmoid(lam.float())
    a = torch.exp(log_a)                                      # in (0, 1)
    gx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xr32)
    if cfg.use_kernels and a.shape[1] > 1:
        hs, h_f = rg.rglru_scan(a.contiguous(), gx.contiguous(),
                                h0.contiguous())
    else:
        hs, h_f = linear_scan(a, gx, h0)
    return shard_hint(hs, "acts_ffn"), h_f


def rglru_block_tp(p: RGLRUMixer, x, cfg: ModelConfig,
                   state: Optional[RGLRUState], keep_state: bool):
    """The RG-LRU block of this rank's part ``x`` of the residual stream
    in a sharded step (module doc): the scan on the rank's channels, the
    state's channels gathered whole when ``keep_state``."""
    ax = ctx.sharded().model
    if ctx.split_dim(p.wx.w) != 1:
        return _whole(p, rglru_block, x, cfg, state, keep_state)
    dt = cdt(cfg)
    hcol = ctx.whole_seq(apply_norm(seq_norm(p.norm), x, cfg),
                         grad_sum=True)
    b = hcol.shape[0]
    xr = linear(p.wx, hcol, cfg)                              # (B,S,dr/tp)
    xg = linear(p.wg, hcol, cfg)
    xr, conv_state = causal_conv(p.conv, xr, None if state is None else
                                 ConvState(ctx.local_slice(state.conv.buf,
                                                           2, ax)))
    xr32 = xr.float()
    lru = p.lru

    def gate(lin, bias):
        # this rank's rows of (dr, dr): a partial sum of every channel,
        # reduce-scattered to the rank's channels
        return torch.sigmoid(ctx.scatter_sum(xr32 @ lin.w.float(), 2, ax)
                             + ctx.split(bias.float(), 0, ax))
    r, i = gate(lru.wa, lru.ba), gate(lru.wi, lru.bi)
    h0 = (torch.zeros((b, xr.shape[2]), dtype=torch.float32,
                      device=x.device) if state is None
          else ctx.local_slice(state.h, 1, ax))
    hs, h_f = _rglru_scan(cfg, lru.lam, r, i, xr32, h0)
    out = hs.to(dt) * F.gelu(xg, approximate="tanh")
    out = row_out(out @ p.wo.w.to(dt), p.wo.b, cfg)
    if not keep_state:
        return out, None
    return out, RGLRUState(ctx.all_gather(h_f, 1, ax), ConvState(
        ctx.all_gather(conv_state.buf, 2, ax)))


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
