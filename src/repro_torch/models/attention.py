"""Attention (the port's ``repro.models.attention``): GQA with RoPE or
M-RoPE, full / sliding-window / local variants, causal or bidirectional,
prefill and decode.

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

Inside the sharded train step (``sharding.ctx.sharded``) a layer runs
``attn_block_tp`` on this rank's part of the residual stream: q, k
and v from the local columns of ``wq``, ``wk`` and ``wv`` on the whole
sequence, attention on the rank's heads where the "heads" spec splits
them (K/V heads that do not divide the axis gathered whole, each local q
head taking its own kv group), on whole heads where it does not (or on
the rank's slice of the queries where it splits the sequence), and a
row-parallel ``wo``. The serving steps given rules run
``attn_serve_tp``, the same layout with the caches: prefill and encode
through ``flash_attention`` on the rank's heads when ``cfg.use_kernels``
is set (the queries whole where the spec would split their sequence:
the kernel masks from position 0), and decode against this rank's block
of the cache: its kv heads, or its slots, whose partial softmaxes
(max, sum of exponentials, weighted V) are combined over "model" by
all-reduces.

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
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import shard_hint
from repro_torch.models.layers import Linear, Norm, apply_mrope, \
    apply_norm, apply_rope, cdt, linear, row_out, seq_norm


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, Smax, Hkv, hd)
    v: torch.Tensor


class AttnMixer(nn.Module):
    """``norm``, ``wq``, ``wk``, ``wv``, ``wo`` as in the reference
    (``wo`` with a bias under LayerNorm)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
        self.norm = Norm(d, cfg, device)
        self.wq = Linear(d, q_dim, cfg, device, bias=cfg.attn_bias)
        self.wk = Linear(d, kv_dim, cfg, device, bias=cfg.attn_bias)
        self.wv = Linear(d, kv_dim, cfg, device, bias=cfg.attn_bias)
        self.wo = Linear(q_dim, d, cfg, device,
                         bias=cfg.norm == "layernorm")


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


def windowed_attention(q, k, v, *, window: int, chunk_q: int, scale: float,
                       q_offset: int = 0):
    """Local/SWA attention with per-q-chunk KV slicing: O(S·window) FLOPs.

    The q chunk starting at t attends keys in [t - window, t + cq); KV is
    padded on the left by ``window`` so every slice has one size. The
    queries sit at positions ``q_offset``.. of the keys' sequence.
    """
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    cq = min(chunk_q, sq)
    pq = (-sq) % cq
    nq = (sq + pq) // cq
    span = window + cq
    after = max(0, q_offset + sq + pq - skv)
    q = _fold_gqa(_pad_seq(q, 0, pq), hkv)
    kp, vp = _pad_seq(k, window, after), _pad_seq(v, window, after)
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
            & (kpos[None, :] >= 0) & (kpos[None, :] < skv)
        s = s + torch.where(mask, 0.0, NEG_INF)               # pre-broadcast
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bhgqd", p, vblk.float())
        return out.movedim(3, 1)                              # (B,cq,Hkv,G,hd)

    outs = []
    for qi in range(nq):
        start = q_offset + qi * cq      # kv slice start in padded coords
        outs.append(remat_chunk(q_step, q[:, qi * cq:(qi + 1) * cq],
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
    returns an updated copy) and the same cache is returned. (A sharded
    step runs ``attn_block_tp`` or ``attn_serve_tp``.)
    """
    return _attn_block(p, x, cfg, kind, positions, cache, cache_pos)


def _whole_kv(t, col: bool, share: bool, shape):
    """K or V whole on every "model" rank: gathered from this rank's
    columns, or as computed from a whole ``wk``/``wv``; ``share``: the
    attention reading it is a per-rank share (its gradient summed)."""
    st = ctx.sharded()
    if col:
        t = ctx.gather(t, t.ndim - 1, st.model, share)
    elif share:
        t = ctx.copy(t, st.model)
    return t.reshape(shape)


def attn_block_tp(p: AttnMixer, x, cfg: ModelConfig, kind: str, positions):
    """The sharded train step's attention on this rank's part ``x`` (B, s,
    d) of the residual stream (module doc). Runs whole on every rank
    (``ctx.whole_block``) where the rules do not split ``wq``'s columns
    over "model"."""
    st = ctx.sharded()
    if ctx.split_dim(p.wq.w) != 1:
        return ctx.whole_block(p, lambda xw: _attn_block(
            p, xw, cfg, kind, positions, None, None)[0], x)
    if ctx.split_dim(p.wo.w) != 0:
        raise ValueError("wq's columns are split over 'model' but wo's "
                         "rows are not")
    tp, r = st.model.n, st.model.rank
    b, s_loc, _ = x.shape
    s = s_loc * tp if st.seq else s_loc
    hd, h, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    window = cfg.window if kind in ("swa", "local") else 0
    scale = hd ** -0.5

    hx = apply_norm(seq_norm(p.norm), x, cfg)
    h_cols = ctx.whole_seq(hx, grad_sum=True)     # column-parallel input
    h_whole = []

    def proj(lin):
        if ctx.split_dim(lin.w) == 1:
            return linear(lin, h_cols, cfg), True
        if not h_whole:
            h_whole.append(ctx.whole_seq(hx, grad_sum=False))
        return linear(lin, h_whole[0], cfg), False

    (q, _), (k, col_k), (v, col_v) = proj(p.wq), proj(p.wk), proj(p.wv)
    heads = st.model_dim("heads", (b, s, h, hd))    # 2, 1 (queries) or None
    q = shard_hint(q, "heads", "cols", shape=(b, s, h, hd))
    kv_shape = (b, s, hkv, hd)
    if heads == 2 and col_k and col_v \
            and st.model_dim("heads", kv_shape) == 2:
        k = shard_hint(k, "heads", "cols", shape=kv_shape)
        v = shard_hint(v, "heads", "cols", shape=kv_shape)
    else:
        k = _whole_kv(k, col_k, heads is not None, kv_shape)
        v = _whole_kv(v, col_v, heads is not None, kv_shape)
        if heads == 2:                  # each local q head's kv group
            k, v = _kv_groups(k, v, h, r, tp)

    q_off = r * (s // tp) if heads == 1 else 0
    q, k = _rope_qk(q, k, positions, cfg, q_off)
    out = _attend(q, k, v, cfg, window, scale, q_off)
    o = out.reshape(b, q.shape[1], -1).to(cdt(cfg))
    if heads == 1:                      # the queries' slices, whole again
        o = ctx.gather(o, 1, st.model, False)
    if heads != 2:                      # this rank's rows of wo
        o = ctx.split(o, 2, st.model)
    return row_out(o @ p.wo.w.to(cdt(cfg)), p.wo.b, cfg)


def _kv_groups(k, v, h: int, r: int, tp: int):
    """The kv heads rank ``r``'s ``h / tp`` q heads read, of whole K and V
    (B, S, Hkv, hd): their groups in order where the local q heads cover
    whole groups, the one group where they all read one (a GQA ratio of
    h / tp, as ``flash_attention`` folds it), else one kv head per q
    head."""
    hq, g = h // tp, h // k.shape[2]
    if hq % g == 0:
        return tuple(t.narrow(2, r * hq // g, hq // g) for t in (k, v))
    if g % hq == 0:
        return tuple(t.narrow(2, r * hq // g, 1) for t in (k, v))
    idx = torch.arange(r * hq, (r + 1) * hq, device=k.device) // g
    return tuple(t.index_select(2, idx) for t in (k, v))


def attn_serve_tp(p: AttnMixer, x, cfg: ModelConfig, kind: str, positions,
                  cache: Optional[KVCache], cache_pos: Optional[int]):
    """A serving step's attention on this rank's part ``x`` (B, s, d) of
    the residual stream (module doc). Prefill and encode (no ``cache``):
    (this rank's part of the output, the whole sequence's (k, v) on this
    rank's kv heads where attention ran on them, else on all). Decode:
    (the output, ``cache``, this rank's block, written in place). Runs
    whole on every rank (``ctx.whole_block``, the cache gathered) where
    the rules do not split ``wq``'s columns and ``wo``'s rows."""
    st = ctx.sharded()
    ax = st.model
    if ctx.split_dim(p.wq.w) != 1 or ctx.split_dim(p.wo.w) != 0:
        whole = None if cache is None else KVCache(
            *(ctx.whole_leaf(t) for t in cache))
        out, kv = ctx.whole_block(p, lambda xw: _attn_block(
            p, xw, cfg, kind, positions, whole, cache_pos), x)
        if cache is not None:
            for t, w in zip(cache, kv):
                dim = getattr(t, "model_dim", None)
                t.copy_(w if dim is None else ctx.local_slice(w, dim, ax))
            kv = cache
        return out, kv
    tp, r = ax.n, ax.rank
    b, s_loc, _ = x.shape
    s = s_loc * tp if st.seq else s_loc
    hd, h, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    window = cfg.window if kind in ("swa", "local") else 0
    scale = hd ** -0.5
    hx = ctx.whole_seq(apply_norm(seq_norm(p.norm), x, cfg), grad_sum=True)
    q = linear(p.wq, hx, cfg)
    heads = st.model_dim("heads", (b, s, h, hd))
    if heads == 1 and (cache is not None or cfg.use_kernels):
        heads = None                    # the kernel masks from position 0
    if cache is not None and getattr(cache.k, "model_dim", None) == 1:
        heads = None                    # every rank its slots of each head
    if heads == 2:
        q = q.reshape(b, s, h // tp, hd)
    else:
        q = ctx.gather(q, 2, ax, False).reshape(b, s, h, hd)
    kv = []
    for lin in (p.wk, p.wv):
        t = linear(lin, hx, cfg)
        if ctx.split_dim(lin.w) == 1:
            t = ctx.gather(t, 2, ax, False) if heads != 2 or hkv % tp \
                else t.reshape(b, s, hkv // tp, hd)
        kv.append(t.reshape(b, s, -1, hd))
    k, v = kv
    q_off = r * (s // tp) if heads == 1 else 0
    if heads == 1:
        q = ctx.local_slice(q, 1, ax)
    q, k = _rope_qk(q, k, positions, cfg, q_off)
    if cache is not None:
        out = _decode_tp(q, k, v, cache, cache_pos, window, scale, h)
        kv = cache
    else:
        kv = KVCache(k, v)
        if heads == 2 and k.shape[2] == hkv:
            k, v = _kv_groups(k, v, h, r, tp)
        if cfg.use_kernels:
            out = kops.flash_attention(q, k, v, causal=cfg.causal,
                                       window=window, scale=scale)
        else:
            out = _attend(q, k, v, cfg, window, scale, q_off)
    o = out.reshape(b, q.shape[1], -1).to(cdt(cfg))
    if heads == 1:                      # the queries' slices, whole again
        o = ctx.gather(o, 1, ax, False)
    if heads != 2:                      # this rank's rows of wo
        o = ctx.split(o, 2, ax)
    return row_out(o @ p.wo.w.to(cdt(cfg)), p.wo.b, cfg), kv


def _decode_tp(q, k, v, cache: KVCache, pos: int, window: int,
               scale: float, h: int):
    """One decode step's attention against this rank's block of the
    cache (its ``model_dim``: 2 its kv heads, 1 its slots, None all of
    it): the new k, v (B,1,·,hd), on the rank's kv heads or on all,
    written where this rank holds their slot, and the softmax over the
    rank's slots combined over "model" where the slots are split. q:
    (B,1,Hq,hd), the rank's q heads or all ``h`` (all where the slots
    are split: the combine sums the ranks' shares of each head); returns
    (B,1,Hq,hd)."""
    ax = ctx.sharded().model
    lay = getattr(cache.k, "model_dim", None)
    c = cache.k.shape[1]
    hkv = cache.k.shape[2]
    if lay == 2 and k.shape[2] != hkv:
        k, v = (ctx.local_slice(t, 2, ax) for t in (k, v))
    base = ax.rank * c if lay == 1 else 0
    total = c * ax.n if lay == 1 else c
    slot = pos if window == 0 else pos % total
    if base <= slot < base + c:
        at = slot - base
        cache.k[:, at:at + 1] = k.to(cache.k.dtype)
        cache.v[:, at:at + 1] = v.to(cache.v.dtype)
    ck, cv = cache
    if q.shape[2] != h and lay is None:     # the local q heads' kv groups
        ck, cv = _kv_groups(ck, cv, h, ax.rank, ax.n)
    idx = base + torch.arange(c, device=q.device)
    if window == 0:
        valid = idx <= pos
    else:
        valid = (pos - (pos - idx) % window) >= 0
    qf = _fold_gqa(q, ck.shape[2]).float()
    if lay != 1:
        return _softmax_out(qf, KVCache(ck, cv), valid, scale)
    import torch.distributed as dist
    bsz, _, g_kv, g, hd = qf.shape
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, ck.float()) * scale
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    m = ctx.all_reduce(sc.amax(dim=-1, keepdim=True), ax, dist.ReduceOp.MAX)
    pr = torch.exp(sc - m)
    den = ctx.all_reduce(pr.sum(dim=-1), ax)
    out = ctx.all_reduce(torch.einsum("bhgqk,bkhd->bhgqd", pr, cv.float()),
                         ax) / den[..., None]
    return out.movedim(3, 1).reshape(bsz, 1, g_kv * g, hd)


def _attn_block(p: AttnMixer, x, cfg: ModelConfig, kind: str, positions,
                cache: Optional[KVCache], cache_pos: Optional[int]):
    b, s, _ = x.shape
    hd = cfg.hd
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    window = cfg.window if kind in ("swa", "local") else 0
    scale = hd ** -0.5

    hx = apply_norm(p.norm, x, cfg)
    q = shard_hint(linear(p.wq, hx, cfg).reshape(b, s, h, hd), "heads")
    k = shard_hint(linear(p.wk, hx, cfg).reshape(b, s, hkv, hd), "heads")
    v = shard_hint(linear(p.wv, hx, cfg).reshape(b, s, hkv, hd), "heads")
    q, k = _rope_qk(q, k, positions, cfg)

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
    else:
        out = _attend(q, k, v, cfg, window, scale)
    out = out.reshape(b, s, h * hd).to(cdt(cfg))
    return linear(p.wo, out, cfg), KVCache(k, v)


def _rope_qk(q, k, positions, cfg: ModelConfig, q_off: int = 0):
    """RoPE (or M-RoPE) on k at ``positions`` (B, S) or (3, B, S), and on
    q at the ``q.shape[1]`` of them from ``q_off`` (its slice of the
    sequence); positions 0.. where None."""
    if positions is None:
        positions = torch.arange(k.shape[1], device=k.device)[None, :]
    if cfg.mrope:
        pos = positions if positions.ndim == 3 else positions.expand(
            3, *positions.shape)

        def rot(t, at):
            return apply_mrope(t, at, cfg.rope_theta, cfg.mrope_sections)
    else:
        pos = positions

        def rot(t, at):
            return apply_rope(t, at, cfg.rope_theta)
    return rot(q, pos.narrow(-1, q_off, q.shape[1])), rot(k, pos)


def _attend(q, k, v, cfg: ModelConfig, window: int, scale: float,
            q_off: int = 0):
    """The plain path's attention: ``windowed_attention`` for a window,
    else ``blocked_attention``; the queries at positions ``q_off``.."""
    if window > 0:
        return windowed_attention(q, k, v, window=window,
                                  chunk_q=cfg.attn_q_chunk, scale=scale,
                                  q_offset=q_off)
    return blocked_attention(q, k, v, causal=cfg.causal, window=0,
                             q_offset=q_off, chunk_q=cfg.attn_q_chunk,
                             chunk_kv=cfg.attn_kv_chunk, scale=scale)
