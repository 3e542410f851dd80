"""Model assembly (the port's ``repro.models.model``): the layer stack,
its caches, prefill, decode and the training loss.

The reference stacks each homogeneous layer group and runs it with
``lax.scan``; the port keeps one module per layer (``LM.layers``, in the
order of ``cfg.pattern()``, which is the reference's group order) and
runs them as a Python loop. Caches are a list with one entry per layer in
place of the reference's stacked ``repeats`` dim: a ``KVCache`` for an
attention layer, an ``RGLRUState``, ``MLSTMState`` or ``SLSTMState`` for
a recurrent one.

The stack takes token ids through ``embed`` or, for a model with a
modality frontend, frame or patch embeddings through ``frontend_proj``
(HuBERT has no ``embed``). Positions are (B, S), or (3, B, S) for
M-RoPE's (t, h, w) streams; left out, every stream counts 0.. S-1 (from
``cache_pos`` in decode), as in the reference. ``encode`` is the
encoder-only entry point (HuBERT): full-sequence logits.

An attention layer's MLP is the MoE FFN (``models.moe``) when
``cfg.n_experts`` is set; its load-balancing loss, summed over the
layers, is the third value ``forward`` returns (0 without MoE), and
``loss_fn`` adds it to the LM loss, as the reference does.

Training (``mode="train"``, ``loss_fn``) runs each pattern unit of
layers under ``cfg.remat``: ``none``; ``full``, one non-reentrant
checkpoint per unit (``jax.checkpoint`` with nothing saveable); ``dots``,
a selective checkpoint that keeps the unit's matrix products
(``checkpoint_dots``); ``group:k``, one checkpoint per k units around a
checkpoint per unit. ``chunked_lm_loss`` checkpoints each 1,024-token
chunk of the loss, so (B, S, V) logits never exist at once.

In the sharded train step (``sharding.ctx.sharded``) each pattern unit's
parameters are gathered over the dp axes inside the unit's body
(``ctx.gathered``), so a checkpoint's recompute gathers them again, and
the residual stream is this rank's part of the sequence where the "acts"
spec splits it. Attention, the MLPs, the MoE FFN, the recurrent mixers
(their "acts_ffn" widths), the embedding and the loss compute this
rank's "model" parts. Under remat ``none`` autograd keeps each unit's
gathered weights (its "model" part, whole over the dp axes) for the
backward.

The serving steps given rules (``models.steps``) run ``forward`` in the
same context in prefill, decode and encode mode: each layer's dp gather
around it, the same "model" parts, vocab-split logits, and each layer's
cache this rank's block of what ``rules.cache_shardings`` lays out: a
KV cache split over its kv heads where they divide the axis, else over
its slots (a window layer's ring-buffer slots included), and the mLSTM
memory by the same "kv_cache" rule; the other recurrent states whole.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch import _device
from repro_torch.models import recurrent as rec
from repro_torch.models.attention import AttnMixer, KVCache, attn_block, \
    attn_block_tp, attn_serve_tp, remat_chunk
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, Embed, Linear, Norm, apply_mlp, \
    apply_norm, cdt, cross_entropy, embed_tokens, linear, seq_norm, \
    unembed, unembed_split, vocab_parallel_ce
from repro_torch.models.moe import MoE, apply_moe
from repro_torch.models.schema import ATTN_KINDS, layer_groups
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import shard_hint

_MIXERS = {"rglru": rec.RGLRUMixer, "mlstm": rec.MLSTMMixer,
           "slstm": rec.SLSTMMixer}
_BLOCKS = {"rglru": rec.rglru_block, "mlstm": rec.mlstm_block,
           "slstm": rec.slstm_block}
_BLOCKS_TP = {"rglru": rec.rglru_block_tp, "mlstm": rec.mlstm_block_tp,
              "slstm": rec.slstm_block_tp}


class Block(nn.Module):
    """One layer: ``mixer`` and, for attention kinds with d_ff > 0,
    ``mlp``: the SwiGLU or GELU MLP, or the MoE FFN when ``cfg.n_experts``
    is set (recurrent blocks carry no MLP, as in the reference)."""

    def __init__(self, cfg: ModelConfig, kind: str, device):
        super().__init__()
        self.kind = kind
        self.mixer = _MIXERS.get(kind, AttnMixer)(cfg, device)
        self.mlp = None
        if cfg.d_ff > 0 and kind in ATTN_KINDS:
            self.mlp = (MoE(cfg, device) if cfg.n_experts
                        else MLP(cfg, device))


class LM(nn.Module):
    """``frontend_proj`` (with a modality frontend), ``embed`` (unless the
    frontend is audio frames), ``layers``, ``final_norm`` and, unless the
    embedding is tied, ``lm_head``. Parameters are left uninitialised:
    fill them with ``convert.params_from_reference`` (or build with
    ``init_model``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = _device.resolve(device)
        self.frontend_proj = (Linear(cfg.d_frontend, cfg.d_model, cfg,
                                     device) if cfg.frontend else None)
        self.embed = (None if cfg.frontend == "audio_frames"
                      else Embed(cfg, device))
        self.layers = nn.ModuleList(Block(cfg, kind, device)
                                    for kind in cfg.pattern())
        self.final_norm = Norm(cfg.d_model, cfg, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else Linear(cfg.d_model, cfg.vocab_size, cfg, device))

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _attn_cache_init(cfg: ModelConfig, kind: str, b: int, cap: int, device):
    window = cfg.window if kind in ("swa", "local") else 0
    c = min(window, cap) if window else cap
    shape = (b, c, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=cdt(cfg), device=device),
                   torch.zeros(shape, dtype=cdt(cfg), device=device))


def _mixer_cache_init(cfg: ModelConfig, kind: str, b: int, cap: int,
                      device):
    d = cfg.d_model
    if kind in ATTN_KINDS:
        return _attn_cache_init(cfg, kind, b, cap, device)
    if kind == "mlstm":
        de = 2 * d
        return rec.mlstm_state_init(b, cfg.n_heads, de // cfg.n_heads, de,
                                    device)
    if kind == "slstm":
        return rec.slstm_state_init(b, d, device)
    if kind == "rglru":
        return rec.rglru_state_init(b, cfg.lru_d, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, cap: int, device=None):
    """Empty decode caches, one per layer."""
    device = _device.resolve(device)
    return [_mixer_cache_init(cfg, kind, batch, cap, device)
            for kind in cfg.pattern()]


def prefill_cache_meta(cfg: ModelConfig, batch: int, seq: int,
                       pad_to: int = 0):
    """The caches ``prefill`` returns for ``batch`` prompts of ``seq``
    tokens, as meta tensors (their shapes and dtypes): a window layer's
    ring of ``window`` slots, a full-attention cache of max(seq,
    ``pad_to``), the recurrent states."""
    meta = torch.device("meta")
    return [_attn_cache_init(cfg, kind, batch, cfg.window if kind in (
        "swa", "local") and cfg.window else max(seq, pad_to), meta)
        if kind in ATTN_KINDS else
        _mixer_cache_init(cfg, kind, batch, seq, meta)
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
    """One layer. Returns (x, new_cache, aux): aux is the MoE FFN's
    load-balancing loss, a 0-dim f32 zero without one."""
    if ctx.sharded() is not None:
        out, c_new = _mixer_tp(block, x, cfg, cache, positions, cache_pos,
                               mode, prefill_pad)
    elif block.kind in _BLOCKS:
        out, c_new = _BLOCKS[block.kind](block.mixer, x, cfg, cache)
    else:
        out, c_new = attn_block(block.mixer, x, cfg, block.kind,
                                positions=positions, cache=cache,
                                cache_pos=cache_pos)
        if mode == "prefill":
            c_new = _prefill_attn_cache(cfg, block.kind, c_new, prefill_pad)
    x = shard_hint(x + out, "acts")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if isinstance(block.mlp, MoE):
        mo, aux = apply_moe(block.mlp, x, cfg)
        x = shard_hint(x + mo, "acts")
    elif block.mlp is not None:
        x = shard_hint(x + apply_mlp(block.mlp, x, cfg), "acts")
    return x, c_new, aux


def _mixer_tp(block: Block, x, cfg: ModelConfig, cache, positions,
              cache_pos, mode: str, prefill_pad: int):
    """A layer's mixer in a sharded step: (this rank's part of its
    output, its cache laid out for this rank, or None in train and
    encode mode)."""
    keep = mode in ("prefill", "decode")
    if block.kind in _BLOCKS_TP:
        return _BLOCKS_TP[block.kind](block.mixer, x, cfg, cache, keep)
    if mode == "train":
        return attn_block_tp(block.mixer, x, cfg, block.kind, positions), \
            None
    out, kv = attn_serve_tp(block.mixer, x, cfg, block.kind, positions,
                            cache, cache_pos)
    if mode != "prefill":
        return out, kv if keep else None
    kv = _prefill_attn_cache(cfg, block.kind, kv, prefill_pad)
    # this rank's block of the cache: its kv heads (kept where attention
    # ran on them), else its slots, else all of it
    st = ctx.sharded()
    hkv = cfg.n_kv_heads
    dim = st.model_dim("kv_cache", (kv.k.shape[0], kv.k.shape[1], hkv,
                                    cfg.hd))
    if kv.k.shape[2] != hkv:            # the rank's kv heads already
        for t in kv:
            t.model_dim = dim
        return out, kv
    return out, KVCache(*(ctx.leaf_part(t, dim) for t in kv))


# The matrix products a ``dots`` checkpoint keeps: every projection of a
# layer reaches ``aten.mm`` (a (B, S, d) @ (d, n) product folds its batch
# dims). ``aten.bmm`` is left out on purpose: in this model it is only
# attention's chunk einsums, which the reference recomputes (they sit in
# their own checkpoint, inside which nothing is saveable); keeping them
# would hold every chunk pair's f32 scores, 2 GB a layer at (8, 2048).
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(fn, context_fn=noop_context_fn):
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)
    return run


def _remat(fn, cfg: ModelConfig):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return _checkpointed(fn, functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    return _checkpointed(fn)


def _group_k(cfg: ModelConfig) -> int:
    """remat='group:k' -> k (0 = plain per-unit remat)."""
    if cfg.remat.startswith("group:"):
        return int(cfg.remat.split(":")[1])
    return 0


def _train_stack(model: LM, cfg: ModelConfig, x, positions):
    """The layer stack in train mode, unit by unit under ``cfg.remat``
    (the reference's scan over each group's repeats). Returns (x, the
    layers' summed aux), the aux carried through every checkpoint as the
    reference carries it through its scans."""
    def unit_body(x, aux, blocks):
        with ctx.gathered(blocks):
            for block in blocks:
                x, _, a = _apply_block(block, x, cfg, None, positions, None,
                                       "train")
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    start = 0
    for unit, reps in layer_groups(cfg):
        n = len(unit)
        units = [model.layers[start + r * n:start + (r + 1) * n]
                 for r in range(reps)]
        start += reps * n
        k = _group_k(cfg)
        if k > 1 and reps % k == 0 and reps > k:
            # sqrt(L)-style recursive checkpointing: x is saved once per
            # k units; the backward recomputes a group's units one at a
            # time, each under its own checkpoint
            inner = _checkpointed(unit_body)

            def group_body(x, aux, group):
                for blocks in group:
                    x, aux = inner(x, aux, blocks)
                return x, aux
            outer = _checkpointed(group_body)
            for j in range(0, reps, k):
                x, aux = outer(x, aux, units[j:j + k])
        else:
            body = _remat(unit_body, cfg)
            for blocks in units:
                x, aux = body(x, aux, blocks)
    return x, aux


def forward(model: LM, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None, cache: Optional[List] = None,
            cache_pos: Optional[int] = None, mode: str = "prefill",
            prefill_pad: int = 0):
    """Run the stack on ``tokens`` (B, S) or ``embeds`` (B, S,
    d_frontend). Returns (x_final, new_cache, aux_loss).

    mode: train (no caches; ``new_cache`` is None) | prefill (produce
    caches) | decode (consume them) | encode (inference without caches:
    ``encode``'s route when no gradient is wanted; ``new_cache`` is
    None). ``aux_loss`` is the MoE layers' summed load-balancing loss (a
    0-dim f32 zero without MoE).
    """
    if mode not in ("train", "prefill", "decode", "encode"):
        raise ValueError(f"mode={mode!r}")
    if mode == "train" and cfg.use_kernels:
        raise NotImplementedError(
            "training with use_kernels=True: the CUDA kernels "
            "flash_attention and rglru_scan have no backward (nor have the "
            "JAX package's Pallas kernels); train with use_kernels=False "
            "(ROADMAP.md, queue item 11)")
    st = ctx.sharded()
    src = "whole"       # in a sharded step: what each rank holds
    b, s = (embeds if embeds is not None else tokens).shape[:2]
    if st is not None:
        st.begin_stream((b, s, cfg.d_model))
    with ctx.gathered([model.frontend_proj, model.embed] if st else []):
        if embeds is not None and st is not None:
            # this rank's part of the stream only (the frontend's weight
            # read by a sequence part: its gradient summed over "model")
            e = embeds.to(cdt(cfg))
            if st.seq:
                e, src = ctx.split(e, 1, st.model), "local"
            x = e @ ctx.seq_param(model.frontend_proj.w).to(cdt(cfg))
        elif embeds is not None:
            x = linear(model.frontend_proj, embeds.to(cdt(cfg)), cfg)
        elif model.embed is None:
            # the reference fails here too, on its missing "embed" leaf
            raise ValueError(f"{cfg.name} has no token embedding: it takes "
                             "frame embeddings (embeds=), not token ids")
        else:
            x = embed_tokens(model.embed, tokens, cfg)
            if ctx.split_dim(model.embed.w) == 0:
                src = "partial"     # a vocab-parallel lookup
    if positions is None:
        base = torch.arange(s, device=x.device)[None, :]
        if mode == "decode":
            base = base + cache_pos
        positions = base.expand(*((3,) if cfg.mrope else ()), b, -1)
    x = shard_hint(x, "acts", src)
    if mode == "train":
        x, aux = _train_stack(model, cfg, x, positions)
        with ctx.gathered([model.final_norm] if st else []):
            return apply_norm(seq_norm(model.final_norm), x, cfg), None, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = []
    for li, block in enumerate(model.layers):
        ci = cache[li] if cache is not None else None
        with ctx.gathered([block] if st else []):
            x, c_new, a = _apply_block(block, x, cfg, ci, positions,
                                       cache_pos, mode, prefill_pad)
        aux = aux + a
        new_cache.append(c_new)
    with ctx.gathered([model.final_norm] if st else []):
        x = apply_norm(seq_norm(model.final_norm), x, cfg)
    return x, (None if mode == "encode" else new_cache), aux


# ---------------------------------------------------------------------------
# losses / logits
# ---------------------------------------------------------------------------

def chunked_lm_loss(model: LM, cfg: ModelConfig, x, labels,
                    chunk: int = 1024):
    """Cross-entropy without materializing (B, S, V): one checkpointed
    chunk of ``chunk`` tokens at a time, its logits recomputed in the
    backward. The mean of the ``s // chunk`` chunk means. In the sharded
    step ``x`` is this rank's part of the stream, gathered whole along
    the sequence here, and the logits are this rank's vocabulary part
    where the rules split the unembedding (``vocab_parallel_ce``)."""
    st = ctx.sharded()
    split = st is not None and unembed_split(model, cfg)
    x = ctx.whole_seq(x, grad_sum=split)
    b, s, d = x.shape
    ck = min(chunk, s)
    n = s // ck
    xs = x.reshape(b, n, ck, d)
    ls = labels.reshape(b, n, ck)

    # the weight is an argument of the checkpointed chunk, so that its
    # recompute reads what this call read (in the sharded step the dp
    # gather, which is gone from the model by then)
    w = model.embed.w if cfg.tie_embeddings else model.lm_head.w

    def body(xc, lc, w):
        w = w.to(cdt(cfg))
        logits = shard_hint(xc @ (w.T if cfg.tie_embeddings else w),
                            "logits")
        if split:
            return vocab_parallel_ce(logits, lc, st.model)
        return cross_entropy(logits, lc)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        tot = tot + remat_chunk(body, xs[:, i], ls[:, i], w)
    return tot / n


def lm_logits(model: LM, cfg: ModelConfig, x):
    """The logits of ``x``; in a sharded step, of each of its rows and
    positions, this rank's part of the vocabulary where the rules split
    the unembedding."""
    head = model.embed if cfg.tie_embeddings else model.lm_head
    with ctx.gathered([head] if ctx.sharded() else []):
        return shard_hint(unembed(model, x, cfg), "logits")


def _last_token(x):
    """The stream's last position (B, 1, d); in a sharded step whose
    stream is split along the sequence, gathered from the rank that
    holds it."""
    st = ctx.sharded()
    if st is not None and st.seq:
        return ctx.gather(x[:, -1:], 1, st.model, False)[:, -1:]
    return x[:, -1:, :]


def loss_fn(model: LM, cfg: ModelConfig, batch):
    """batch: {tokens | embeds, labels?, positions?} tensors on the
    model's device. Without labels, tokens are shifted here (causal
    LM)."""
    tokens = batch.get("tokens")
    embeds = batch.get("embeds")
    positions = batch.get("positions")
    if "labels" in batch:                   # pipeline provides shifted labels
        labels = batch["labels"]
        inputs = tokens
    else:                                   # causal LM fallback: shift here
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        if positions is not None:
            positions = positions[..., :-1]
    x, _, aux = forward(model, cfg, tokens=inputs, embeds=embeds,
                        positions=positions, mode="train")
    head = [model.embed if cfg.tie_embeddings else model.lm_head]
    with ctx.gathered(head if ctx.sharded() else []):
        return chunked_lm_loss(model, cfg, x, labels) + aux


def decay_ndims(model: LM) -> dict:
    """{parameter name: the ndim AdamW's decay rule reads}. The reference
    stores each layer group stacked, with a leading repeats dim, and
    decays every leaf of ndim >= 2 (``optim/adamw.py:80``): a layer's 1-D
    tensors (norm scales, biases, Λ) count one dim more there and are
    decayed (the MoE FFN's norm among them). The port mirrors that; only
    top-level 1-D tensors escape."""
    return {name: p.ndim + name.startswith("layers.")
            for name, p in model.named_parameters()}


def prefill(model: LM, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None, pad_to: int = 0):
    """Returns (last_token_logits (B, V), cache)."""
    x, cache, _ = forward(model, cfg, tokens=tokens, embeds=embeds,
                          positions=positions, mode="prefill",
                          prefill_pad=pad_to)
    return lm_logits(model, cfg, _last_token(x))[:, 0, :], cache


def decode_step(model: LM, cfg: ModelConfig, cache, token, pos: int):
    """One decode step. token: (B, 1) int; pos: the write slot. Returns
    (logits (B, V), new_cache)."""
    x, new_cache, _ = forward(model, cfg, tokens=token, cache=cache,
                              cache_pos=pos, mode="decode")
    return lm_logits(model, cfg, x)[:, 0, :], new_cache


def encode(model: LM, cfg: ModelConfig, embeds):
    """Encoder-only forward (HuBERT): logits (B, S, V) of every frame.

    The reference runs its train-mode stack here. When a gradient is
    wanted (autograd on, and ``embeds`` or a parameter requires grad), so
    does the port, and ``use_kernels=True`` raises as in training (the
    kernels have no backward). Otherwise the same layers run as an
    inference pass without caches, through ``flash_attention`` when
    ``cfg.use_kernels`` is set."""
    wants_grad = torch.is_grad_enabled() and (
        embeds.requires_grad or any(p.requires_grad
                                    for p in model.parameters()))
    with torch.set_grad_enabled(wants_grad):
        x, _, _ = forward(model, cfg, embeds=embeds,
                          mode="train" if wants_grad else "encode")
        return lm_logits(model, cfg, ctx.whole_seq(x, grad_sum=False))
