"""The weights of a configuration, made on the device from the seed.

``layout(arch)`` names every tensor of a decoder as the program under test
keeps its parameters (``embed.w``; per layer ``layers.<i>.mixer.{norm.
scale, wq.w, wk.w, wv.w, wo.w}`` and ``layers.<i>.mlp.{norm.scale, wi.w,
wo.w}``, or with experts ``layers.<i>.mlp.{norm.scale, router.w, wi,
wo}``; ``final_norm.scale``, and ``lm_head.w`` unless the configuration
ties the head to the embedding), matrices as (inputs, outputs) and SwiGLU's gate and up fused as the first and second half of
``wi``'s outputs. ``make`` draws them all in one call of a generator on
the device, in the type they are served in, then scales each slice:
a matrix by 1 / sqrt(its inputs) (the embedding by 0.02), a norm scale to
1 + 0.1 N(0, 1) so that every norm's weight matters. The same seed gives
the same tensors; both the program and the reference read them.
"""
from __future__ import annotations

import math

import torch


def layout(arch: dict):
    """[(name, shape, scale)]; ``scale`` None marks a norm scale."""
    d, ff, v = arch["hidden_size"], arch["intermediate_size"], \
        arch["vocab_size"]
    hd = arch["head_dim"]
    q, kv = arch["num_attention_heads"] * hd, \
        arch["num_key_value_heads"] * hd
    e = arch.get("num_local_experts") or 0
    out = [("embed.w", (v, d), 0.02)]
    for i in range(arch["num_hidden_layers"]):
        a, m = f"layers.{i}.mixer.", f"layers.{i}.mlp."
        out += [(a + "norm.scale", (d,), None),
                (a + "wq.w", (d, q), d ** -0.5),
                (a + "wk.w", (d, kv), d ** -0.5),
                (a + "wv.w", (d, kv), d ** -0.5),
                (a + "wo.w", (q, d), q ** -0.5),
                (m + "norm.scale", (d,), None)]
        if e:
            out += [(m + "router.w", (d, e), d ** -0.5),
                    (m + "wi", (e, d, 2 * ff), d ** -0.5),
                    (m + "wo", (e, ff, d), ff ** -0.5)]
        else:
            out += [(m + "wi.w", (d, 2 * ff), d ** -0.5),
                    (m + "wo.w", (ff, d), ff ** -0.5)]
    out += [("final_norm.scale", (d,), None)]
    if not arch["tie_word_embeddings"]:
        out += [("lm_head.w", (d, v), d ** -0.5)]
    return out


def make(arch: dict, seed: int, device) -> dict:
    """{name: tensor} of ``layout(arch)`` from ``seed``: views of one
    buffer of ``arch["param_dtype"]`` filled by one normal draw."""
    dtype = getattr(torch, arch["param_dtype"])
    spec = layout(arch)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    out, at = {}, 0
    for name, shape, scale in spec:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        if scale is None:
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(scale)
        out[name] = t
        at += n
    return out
