"""Model assembly (the port's ``repro.models.model``): the layer stack,
its caches, prefill, decode and the training loss.

The reference stacks each homogeneous layer group and runs it with
``lax.scan``; the port keeps one module per layer (``LM.layers``, in the
order of ``cfg.pattern()``, which is the reference's group order) and
runs them as a Python loop. Caches are a list with one entry per layer in
place of the reference's stacked ``repeats`` dim: a ``KVCache`` for an
attention layer, an ``RGLRUState`` for an RG-LRU layer.

Training (``mode="train"``, ``loss_fn``) runs each pattern unit of
layers under ``cfg.remat``: ``none``; ``full``, one non-reentrant
checkpoint per unit (``jax.checkpoint`` with nothing saveable); ``dots``,
a selective checkpoint that keeps the unit's matrix products
(``checkpoint_dots``); ``group:k``, one checkpoint per k units around a
checkpoint per unit. ``chunked_lm_loss`` checkpoints each 1,024-token
chunk of the loss, so (B, S, V) logits never exist at once.
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
    remat_chunk
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, Embed, Linear, Norm, apply_mlp, \
    apply_norm, cdt, cross_entropy, embed_tokens, unembed
from repro_torch.models.schema import ATTN_KINDS, check_ported, layer_groups


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
    (the reference's scan over each group's repeats)."""
    def unit_body(x, blocks):
        for block in blocks:
            x, _ = _apply_block(block, x, cfg, None, positions, None,
                                "train")
        return x

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

            def group_body(x, group):
                for blocks in group:
                    x = inner(x, blocks)
                return x
            outer = _checkpointed(group_body)
            for j in range(0, reps, k):
                x = outer(x, units[j:j + k])
        else:
            body = _remat(unit_body, cfg)
            for blocks in units:
                x = body(x, blocks)
    return x


def forward(model: LM, cfg: ModelConfig, *, tokens, positions=None,
            cache: Optional[List] = None, cache_pos: Optional[int] = None,
            mode: str = "prefill", prefill_pad: int = 0):
    """Run the stack. Returns (x_final, new_cache).

    mode: train (no caches; ``new_cache`` is None) | prefill (produce
    caches) | decode (consume them).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode={mode!r}")
    if mode == "train" and cfg.use_kernels:
        raise NotImplementedError(
            "training with use_kernels=True: the CUDA kernels "
            "flash_attention and rglru_scan have no backward (nor have the "
            "JAX package's Pallas kernels); train with use_kernels=False "
            "(ROADMAP.md, queue item 11)")
    x = embed_tokens(model.embed, tokens, cfg)
    if positions is None:
        base = torch.arange(x.shape[1], device=x.device)[None, :]
        if mode == "decode":
            base = base + cache_pos
        positions = base.expand(x.shape[0], -1)
    if mode == "train":
        x = _train_stack(model, cfg, x, positions)
        return apply_norm(model.final_norm, x, cfg), None
    new_cache = []
    for li, block in enumerate(model.layers):
        ci = cache[li] if cache is not None else None
        x, c_new = _apply_block(block, x, cfg, ci, positions, cache_pos,
                                mode, prefill_pad)
        new_cache.append(c_new)
    x = apply_norm(model.final_norm, x, cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# losses / logits
# ---------------------------------------------------------------------------

def chunked_lm_loss(model: LM, cfg: ModelConfig, x, labels,
                    chunk: int = 1024):
    """Cross-entropy without materializing (B, S, V): one checkpointed
    chunk of ``chunk`` tokens at a time, its logits recomputed in the
    backward. The mean of the ``s // chunk`` chunk means."""
    b, s, d = x.shape
    ck = min(chunk, s)
    n = s // ck
    xs = x.reshape(b, n, ck, d)
    ls = labels.reshape(b, n, ck)

    def body(xc, lc):
        return cross_entropy(unembed(model, xc, cfg), lc)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        tot = tot + remat_chunk(body, xs[:, i], ls[:, i])
    return tot / n


def lm_logits(model: LM, cfg: ModelConfig, x):
    return unembed(model, x, cfg)


def loss_fn(model: LM, cfg: ModelConfig, batch):
    """batch: {tokens, labels?, positions?} tensors on the model's
    device. Without labels, tokens are shifted here (causal LM)."""
    tokens = batch["tokens"]
    positions = batch.get("positions")
    if "labels" in batch:                   # pipeline provides shifted labels
        labels = batch["labels"]
        inputs = tokens
    else:                                   # causal LM fallback: shift here
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        if positions is not None:
            positions = positions[..., :-1]
    x, _ = forward(model, cfg, tokens=inputs, positions=positions,
                   mode="train")
    return chunked_lm_loss(model, cfg, x, labels)


def decay_ndims(model: LM) -> dict:
    """{parameter name: the ndim AdamW's decay rule reads}. The reference
    stores each layer group stacked, with a leading repeats dim, and
    decays every leaf of ndim >= 2 (``optim/adamw.py:80``): a layer's 1-D
    tensors (norm scales, biases, Λ) count one dim more there and are
    decayed. The port mirrors that; only top-level 1-D tensors escape."""
    return {name: p.ndim + name.startswith("layers.")
            for name, p in model.named_parameters()}


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
