"""A plain decoder-only transformer in float32: token embedding; per layer
a pre-norm grouped-query attention block with rotary embeddings (causal,
optionally within a sliding window) and a pre-norm SwiGLU feed-forward,
dense or top-k mixture of experts; a final RMSNorm and the output head
(the embedding's transpose where the configuration ties them).

It recomputes one served request as the serving engine laid it out, so
that its logits are comparable position by position:

- The request's row is its wave's: left-padded with token 0 to the
  wave's longest prompt, ``prefill_len`` tokens, the pads attended like
  any token and counted from position 0 (the engine does not mask them).
  The generated tokens follow, each at the next position.
- The expert layers route each token to its ``num_experts_per_tok`` best
  experts (softmax of float32 router logits, ties to the lower index,
  gates renormalised over the chosen). Within the prefill row each expert
  takes at most ``capacity(prefill_len)`` (token, choice) pairs, counted
  token by token and choice by choice; a pair past it adds nothing. Each
  generated token is routed on its own, a row of one token.

Weights come as a dict of float32 tensors named as ``bench/weights.py``
makes them; matrices are (inputs, outputs). ``precision="fp8"`` runs the
same equations with every matrix product's operands rounded to float8
(e4m3, a scale per weight column and per activation row), the control
that a correct float32 comparison has to tell apart.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0         # the largest finite float8_e4m3fn


def capacity(tokens: int, arch: dict) -> int:
    """Pairs one expert takes in a row of ``tokens``: tokens * k / E times
    the capacity factor, at least 1, rounded up to a multiple of 4."""
    k, e = arch["num_experts_per_tok"], arch["num_local_experts"]
    cap = int(max(1, (tokens * k / e) * arch["capacity_factor"]))
    return ((cap + 3) // 4) * 4


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim``'s complement (absmax / 448), returned in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Decoder:
    """The reference over ``weights`` for ``arch`` (a configuration
    file's dict). ``precision``: "f32", or "fp8" for the control."""

    def __init__(self, weights: dict, arch: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision={precision!r}")
        self.w, self.a, self.precision = weights, arch, precision
        # with experts: each position's least margin, over the layers,
        # between the last expert chosen and the first left out (the
        # router's probabilities), of the last ``logits`` call
        self.router_margin = None

    # -- pieces ---------------------------------------------------------
    def _mm(self, x, w):
        w = w.float()
        if self.precision == "fp8":
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w

    def _norm(self, x, scale):
        x = x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                            + self.a["rms_norm_eps"])
        return x * scale.float()

    def _rope(self, x, pos):
        """x (T, H, hd): the two halves of each head rotate together."""
        hd = x.shape[-1]
        inv = 1.0 / (self.a["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device)
            / hd))
        ang = pos[:, None].float() * inv                     # (T, hd/2)
        cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def _attention(self, x, p, q_chunk=1024):
        a = self.a
        t = x.shape[0]
        h, hkv, hd = (a["num_attention_heads"], a["num_key_value_heads"],
                      a["head_dim"])
        window = a.get("sliding_window") or 0
        hx = self._norm(x, self.w[p + "norm.scale"])
        pos = torch.arange(t, device=x.device)
        q = self._rope(self._mm(hx, self.w[p + "wq.w"]).view(t, h, hd), pos)
        k = self._rope(self._mm(hx, self.w[p + "wk.w"]).view(t, hkv, hd),
                       pos)
        v = self._mm(hx, self.w[p + "wv.w"]).view(t, hkv, hd)
        g = h // hkv
        k = k.repeat_interleave(g, dim=1)            # q head i reads i // g
        v = v.repeat_interleave(g, dim=1)
        out = torch.empty(t, h, hd, device=x.device)
        kpos = pos[None, :]
        for s0 in range(0, t, q_chunk):
            qpos = pos[s0:s0 + q_chunk, None]
            keep = kpos <= qpos
            if window:
                keep = keep & (kpos > qpos - window)
            sc = torch.einsum("qhd,khd->hqk", q[s0:s0 + q_chunk], k) \
                / math.sqrt(hd)
            sc = sc.masked_fill(~keep[None], float("-inf"))
            out[s0:s0 + q_chunk] = torch.einsum(
                "hqk,khd->qhd", torch.softmax(sc, dim=-1), v)
        return x + self._mm(out.reshape(t, h * hd), self.w[p + "wo.w"])

    def _swiglu(self, h, wi, wo):
        g, u = self._mm(h, wi).chunk(2, dim=-1)
        return self._mm(F.silu(g) * u, wo)

    def _moe(self, h, p, prefill_len: int):
        a = self.a
        e, k = a["num_local_experts"], a["num_experts_per_tok"]
        t = h.shape[0]
        probs = torch.softmax(h @ self.w[p + "router.w"].float(), dim=-1)
        gates, experts = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
        margin = gates[:, k - 1] - gates[:, k]
        self.router_margin = margin if self.router_margin is None else \
            torch.minimum(self.router_margin, margin)
        gates, experts = gates[:, :k], experts[:, :k]
        gates = gates / gates.sum(-1, keepdim=True)
        # keep: the prefill row's pairs within capacity, in token-major,
        # choice-minor order; each generated token is a row of its own
        flat = experts[:prefill_len].reshape(-1)
        nth = (F.one_hot(flat, e).cumsum(0) - 1).gather(1, flat[:, None])
        keep = torch.ones(t, k, dtype=torch.bool, device=h.device)
        keep[:prefill_len] = (nth[:, 0] < capacity(prefill_len, a)).view(
            prefill_len, k)
        dec = experts[prefill_len:]                          # (n, k)
        nth = (F.one_hot(dec, e).cumsum(1) - 1).gather(2, dec[..., None])
        keep[prefill_len:] = nth[..., 0] < capacity(1, a)
        out = torch.zeros_like(h)
        for ex in range(e):
            tok, choice = torch.nonzero((experts == ex) & keep,
                                        as_tuple=True)
            if tok.numel() == 0:
                continue
            y = self._swiglu(h[tok], self.w[p + "wi"][ex],
                             self.w[p + "wo"][ex])
            out.index_add_(0, tok, y * gates[tok, choice][:, None])
        return out

    def _ffn(self, x, p, prefill_len: int):
        h = self._norm(x, self.w[p + "norm.scale"])
        if self.a.get("num_local_experts"):
            return x + self._moe(h, p, prefill_len)
        return x + self._swiglu(h, self.w[p + "wi.w"], self.w[p + "wo.w"])

    # -- the whole model ------------------------------------------------
    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, prefill_len: int,
               first: int) -> torch.Tensor:
        """Float32 logits (T - first, V) at positions first..T-1 of the
        row ``tokens`` (T,), whose first ``prefill_len`` tokens are the
        prefill row (module doc)."""
        self.router_margin = None
        x = self.w["embed.w"].float()[tokens]
        for i in range(self.a["num_hidden_layers"]):
            x = self._attention(x, f"layers.{i}.mixer.")
            x = self._ffn(x, f"layers.{i}.mlp.", prefill_len)
        x = self._norm(x[first:], self.w["final_norm.scale"])
        head = (self.w["embed.w"].T if self.a["tie_word_embeddings"]
                else self.w["lm_head.w"])
        return self._mm(x, head)

    def served_logits(self, prompt, served, prefill_len: int):
        """Logits of the positions that chose each of ``served``'s tokens
        for a request of ``prompt`` padded to ``prefill_len``: row j
        chose served[j]."""
        dev = self.w["embed.w"].device
        row = [0] * (prefill_len - len(prompt)) + list(prompt) \
            + list(served[:-1])
        return self.logits(torch.tensor(row, device=dev), prefill_len,
                           prefill_len - 1)
