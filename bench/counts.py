"""The benchmark's frozen yardstick: the peaks of one NVIDIA H100 and the
operations and bytes of a request and of a ``flash_attention`` call.

The formulae are the benchmark's own copy, so that a change to the
program cannot move the ruler it is measured by. The peaks are the data
sheet's (NVIDIA H100 Tensor Core GPU, SXM column, dense rates without
sparsity, at the 700 W power limit); a card set below 700 W runs slower,
so the harness prints the card's ``power.limit`` beside every result.

``arch`` below is a configuration file's dict (``bench/configs/*.json``,
Hugging Face key names).
"""
from __future__ import annotations

import numpy as np

PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12       # HBM3
HBM_BYTES = 80e9


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs one head's mask keeps, q at positions 0..sq-1 against
    keys at 0..skv-1: key <= query where ``causal``, and key > query -
    ``window`` where ``window`` > 0."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, skv - 1) if causal else np.full_like(q, skv - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros_like(q)
    return int(np.maximum(hi - lo + 1, 0).sum())


def causal_keys(tokens: int, window: int) -> int:
    """Keys summed over a causal run of ``tokens`` queries that each see
    themselves and the ones before, at most ``window`` of them (0: all)."""
    if window <= 0 or window >= tokens:
        return tokens * (tokens + 1) // 2
    return window * (window + 1) // 2 + (tokens - window) * window


def flash_flops(bh: int, sq: int, skv: int, hd: int, causal: bool,
                window: int) -> float:
    """4 * hd FLOPs for each visible (q, k) pair of each of ``bh`` heads
    (QK^T and PV, a multiply and an add each)."""
    return 4.0 * hd * bh * visible_pairs(sq, skv, causal, window)


def flash_bytes(bh: int, bhkv: int, sq: int, skv: int, hd: int,
                itemsize: int) -> float:
    """q, k and v read once and the output written once."""
    return float(itemsize * hd * (2 * bh * sq + 2 * bhkv * skv))


def flash_bound_s(bh: int, bhkv: int, sq: int, skv: int, hd: int,
                  causal: bool, window: int, itemsize: int) -> float:
    """The least time the card could take: the larger of operations at
    the bf16 peak and bytes at the HBM rate."""
    return max(flash_flops(bh, sq, skv, hd, causal, window)
               / PEAK_BF16_FLOPS,
               flash_bytes(bh, bhkv, sq, skv, hd, itemsize)
               / HBM_BYTES_PER_S)


def layer_matmul_flops_per_token(arch: dict) -> float:
    """2 FLOPs a weight of every matrix product one token passes through
    in one layer: q, k, v and o; the dense SwiGLU MLP (gate, up, down) or,
    with experts, the router and ``num_experts_per_tok`` experts."""
    d = arch["hidden_size"]
    hd = arch["head_dim"]
    q = arch["num_attention_heads"] * hd
    kv = arch["num_key_value_heads"] * hd
    ff = arch["intermediate_size"]
    attn = 2.0 * (d * q + 2 * d * kv + q * d)
    e = arch.get("num_local_experts") or 0
    if e:
        ffn = 2.0 * (d * e + arch["num_experts_per_tok"] * 3 * d * ff)
    else:
        ffn = 2.0 * 3 * d * ff
    return attn + ffn


def request_flops(arch: dict, prompt: int, new: int) -> float:
    """Model FLOPs of one request's own tokens: its ``prompt`` tokens and
    the ``new - 1`` generated ones fed back, through every layer (matrix
    products, and attention's 4 * hd a visible pair of each q head over
    the request's own earlier tokens, within the window), and the head
    for each of the ``new`` logit rows it is served from. Padding,
    capacity slack and recomputation are not the request's work."""
    tokens = prompt + new - 1
    window = arch.get("sliding_window") or 0
    hd = arch["head_dim"]
    attn = 4.0 * hd * arch["num_attention_heads"] * causal_keys(tokens,
                                                                window)
    per_layer = layer_matmul_flops_per_token(arch) * tokens + attn
    head = 2.0 * arch["hidden_size"] * arch["vocab_size"] * new
    return arch["num_hidden_layers"] * per_layer + head
