"""Parameter schema (the port's copy of ``repro.models.schema``).

``schema(cfg)`` returns the reference's nested dict of :class:`ParamSpec`
leaves, in the reference's layout: each repeated layer group is stored
*stacked*, with a leading ``repeats`` dim (axis name None). From it come
  * ``param_axes``    : the tree of logical axis names the sharding rules
                        read (``sharding.rules``), the reference's names;
                        ``named_specs`` keys the specs by the port's
                        parameter names, one module per layer, so a
                        layer's leaf drops the stacked leaf's leading None
  * ``count_params``  : the analytic parameter count
  * ``init_numpy``    : a parameter tree of numpy arrays made from a seed,
                        the weights the tests, the golden file's generator
                        and ``chip_smoke.py`` all build (no file is
                        downloaded); ``convert.params_from_reference``
                        turns it into the port's modules.

Every block kind of the reference: attn / swa / local (with their
SwiGLU or GELU MLP, or the MoE FFN when ``cfg.n_experts`` is set),
rglru, mlstm and slstm (no MLP, as in the reference); RMSNorm or
LayerNorm (with its bias, and a bias on attention's ``wo``); the
modality frontend's ``frontend_proj``, and no ``embed`` for audio frames.
"""
from __future__ import annotations

import functools
import math
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from repro_torch.models.config import ModelConfig

ATTN_KINDS = ("attn", "swa", "local")


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | zeros | ones | lambda_lru
    scale: float = 1.0
    axes: Tuple[object, ...] = ()     # logical axis name (str) or None per dim


def _spec(shape, axes, init: str = "normal",
          scale: float = 1.0) -> ParamSpec:
    return ParamSpec(tuple(shape), init, scale, tuple(axes))


def _dense(d_in: int, d_out: int, ax_in, ax_out, *, bias: bool = False,
           scale: float | None = None) -> Dict[str, ParamSpec]:
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    out = {"w": _spec((d_in, d_out), (ax_in, ax_out), "normal", scale)}
    if bias:
        out["b"] = _spec((d_out,), (ax_out,), "zeros")
    return out


def _norm(d: int, kind: str) -> Dict[str, ParamSpec]:
    out = {"scale": _spec((d,), ("embed",), "ones")}
    if kind == "layernorm":
        out["bias"] = _spec((d,), ("embed",), "zeros")
    return out


def _attn_schema(cfg: ModelConfig) -> Dict:
    d, hd = cfg.d_model, cfg.hd
    q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return {"norm": _norm(d, cfg.norm),
            "wq": _dense(d, q_dim, "embed", "qkv", bias=cfg.attn_bias),
            "wk": _dense(d, kv_dim, "embed", "kv", bias=cfg.attn_bias),
            "wv": _dense(d, kv_dim, "embed", "kv", bias=cfg.attn_bias),
            "wo": _dense(q_dim, d, "qkv", "embed",
                         bias=cfg.norm == "layernorm")}


def _mlp_schema(cfg: ModelConfig) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"norm": _norm(d, cfg.norm),
                "wi": _dense(d, 2 * ff, "embed", "ffn"),      # fused gate|up
                "wo": _dense(ff, d, "ffn", "embed")}
    return {"norm": _norm(d, cfg.norm),                       # gelu (HuBERT)
            "wi": _dense(d, ff, "embed", "ffn", bias=True),
            "wo": _dense(ff, d, "ffn", "embed", bias=True)}


def _moe_schema(cfg: ModelConfig) -> Dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"norm": _norm(d, cfg.norm),
            "router": {"w": _spec((d, e), ("embed", None), "normal",
                                  1.0 / math.sqrt(d))},
            "wi": _spec((e, d, 2 * ff), ("experts", "embed", "ffn"),
                        "normal", 1.0 / math.sqrt(d)),
            "wo": _spec((e, ff, d), ("experts", "ffn", "embed"),
                        "normal", 1.0 / math.sqrt(ff))}


def _rglru_schema(cfg: ModelConfig) -> Dict:
    """Griffin recurrent block: x -> [conv4 -> RG-LRU] * gelu(gate) -> out."""
    d, dr = cfg.d_model, cfg.lru_d
    return {
        "norm": _norm(d, cfg.norm),
        "wx": _dense(d, dr, "embed", "ffn"),                  # recurrent in
        "wg": _dense(d, dr, "embed", "ffn"),                  # gate branch
        "conv": {"w": _spec((cfg.conv_width, dr), (None, "ffn"), "normal",
                            0.1),
                 "b": _spec((dr,), ("ffn",), "zeros")},
        "lru": {
            "lam": _spec((dr,), ("ffn",), "lambda_lru"),      # a = σ(Λ)^(c·r)
            "wa": _dense(dr, dr, "ffn", None, scale=1.0 / math.sqrt(dr)),
            "ba": _spec((dr,), (None,), "zeros"),
            "wi": _dense(dr, dr, "ffn", None, scale=1.0 / math.sqrt(dr)),
            "bi": _spec((dr,), (None,), "zeros"),
        },
        "wo": _dense(dr, d, "ffn", "embed"),
    }


def _mlstm_schema(cfg: ModelConfig) -> Dict:
    """xLSTM mLSTM block (up-proj x2, conv, per-head matrix memory)."""
    d = cfg.d_model
    de = 2 * d                        # expansion 2 (xLSTM paper)
    h = cfg.n_heads
    return {
        "norm": _norm(d, cfg.norm),
        "wup": _dense(d, 2 * de, "embed", "ffn"),             # fused x|gate
        "conv": {"w": _spec((cfg.conv_width, de), (None, "ffn"), "normal",
                            0.1),
                 "b": _spec((de,), ("ffn",), "zeros")},
        "wq": _dense(de, de, "ffn", None),
        "wk": _dense(de, de, "ffn", None),
        "wv": _dense(de, de, "ffn", None),
        "wif": _dense(de, 2 * h, "ffn", None),                # i/f pre-acts
        "onorm": {"scale": _spec((de,), ("ffn",), "ones")},
        "wdown": _dense(de, d, "ffn", "embed"),
    }


def _slstm_schema(cfg: ModelConfig) -> Dict:
    """xLSTM sLSTM block: 4 gates, per-head block-diagonal recurrence."""
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    return {
        "norm": _norm(d, cfg.norm),
        "wg": _dense(d, 4 * d, "embed", "ffn"),               # i|f|z|o of x_t
        "rg": _spec((h, hd, 4 * hd), (None, None, None), "normal",
                    1.0 / math.sqrt(hd)),                     # per head
        "bg": _spec((4 * d,), ("ffn",), "zeros"),
        "wo": _dense(d, d, "embed", "qkv"),
    }


_KIND_SCHEMA = {
    "attn": _attn_schema, "swa": _attn_schema, "local": _attn_schema,
    "rglru": _rglru_schema, "mlstm": _mlstm_schema, "slstm": _slstm_schema,
}


def _block_schema(cfg: ModelConfig, kind: str) -> Dict:
    s = {"mixer": _KIND_SCHEMA[kind](cfg)}
    if cfg.d_ff > 0 and kind in ATTN_KINDS:
        s["mlp"] = _moe_schema(cfg) if cfg.n_experts else _mlp_schema(cfg)
    return s


def layer_groups(cfg: ModelConfig):
    """[(unit_kinds, repeats), ...] covering all n_layers in order."""
    unit = cfg.pattern_unit
    reps, rem = divmod(cfg.n_layers, len(unit))
    groups = []
    if reps:
        groups.append((unit, reps))
    if rem:
        groups.append((unit[:rem], 1))
    return groups


def _stack(tree, n: int):
    """Prepend a stacked layer dim (axis name None) to every ParamSpec."""
    if isinstance(tree, ParamSpec):
        return _spec((n, *tree.shape), (None, *tree.axes), tree.init,
                     tree.scale)
    return {k: _stack(v, n) for k, v in tree.items()}


def schema(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    s: Dict = {}
    if cfg.frontend:
        s["frontend_proj"] = _dense(cfg.d_frontend, d, None, "embed")
    if cfg.frontend != "audio_frames":          # HuBERT: no token embedding
        s["embed"] = {"w": _spec((cfg.vocab_size, d), ("vocab", "embed"),
                                 "normal", 0.02)}
    groups = {}
    for gi, (unit, reps) in enumerate(layer_groups(cfg)):
        g = {str(i): _block_schema(cfg, kind) for i, kind in enumerate(unit)}
        groups[str(gi)] = _stack(g, reps)
    s["groups"] = groups
    s["final_norm"] = _norm(d, cfg.norm)
    if not cfg.tie_embeddings:
        s["lm_head"] = _dense(d, cfg.vocab_size, "embed", "vocab")
    return s


def leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, in insertion order; paths are
    '/'-joined keys."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from leaves(v, f"{prefix}/{k}" if prefix else k)


def _tree_map(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: _tree_map(fn, v) for k, v in tree.items()}


def param_axes(cfg: ModelConfig) -> Dict:
    """The schema's tree of logical axes (the reference's ``param_axes``)."""
    return _tree_map(lambda s: s.axes, schema(cfg))


def named_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """{the port's parameter name: its ParamSpec}: a top-level leaf's
    spec as the schema has it, a layer's the stacked leaf's spec without
    its leading repeats dim (``layers.<i>.mixer.wq.w`` of layer i)."""
    sch = schema(cfg)
    out = {}
    for path, spec in leaves({k: v for k, v in sch.items()
                              if k != "groups"}):
        out[path.replace("/", ".")] = spec
    layer = 0
    for gi, (unit, reps) in enumerate(layer_groups(cfg)):
        group = sch["groups"][str(gi)]
        for rep in range(reps):
            for idx in range(len(unit)):
                for path, spec in leaves(group[str(idx)]):
                    name = f"layers.{layer + rep * len(unit) + idx}." \
                        + path.replace("/", ".")
                    out[name] = _spec(spec.shape[1:], spec.axes[1:],
                                      spec.init, spec.scale)
        layer += reps * len(unit)
    return out


def count_params(cfg: ModelConfig) -> int:
    return sum(int(np.prod(s.shape)) for _, s in leaves(schema(cfg)))


STREAM = 1 << 22        # elements drawn from one seeded stream


def _leaf(spec: ParamSpec, seed: int, path: str, jobs: list) -> np.ndarray:
    """One float32 parameter. A ``normal`` leaf is allocated here and
    filled by the ``jobs`` it appends, one per stream of ``STREAM``
    elements, each seeded by (``seed``, the leaf's path, the stream's
    index): no leaf depends on another, and the streams can be drawn in
    parallel."""
    if spec.init == "zeros":
        return np.zeros(spec.shape, np.float32)
    if spec.init == "ones":
        return np.ones(spec.shape, np.float32)
    key = zlib.crc32(path.encode())
    if spec.init == "lambda_lru":
        # a = sigmoid(lam) uniformly in [0.9, 0.999] (Griffin init)
        u = np.random.default_rng([seed, key]).uniform(0.9, 0.999, spec.shape)
        return np.log(u / (1 - u)).astype(np.float32)
    out = np.empty(spec.shape, np.float32)
    flat = out.reshape(-1)
    scale = np.float32(spec.scale)

    def fill(i):
        part = flat[i * STREAM:(i + 1) * STREAM]
        np.random.default_rng([seed, key, i]).standard_normal(
            part.size, dtype=np.float32, out=part)
        part *= scale
    jobs.extend(functools.partial(fill, i)
                for i in range(-(-flat.size // STREAM)))
    return out


def init_numpy(cfg: ModelConfig, seed: int = 0) -> Dict:
    """The parameter tree of ``cfg`` as float32 numpy arrays, in the
    reference's layout, made from ``seed`` (normal x scale, zeros, ones,
    and Griffin's Λ). The streams are drawn on a few threads; the result
    does not depend on their number or order."""
    jobs: list = []

    def mk(tree, path):
        if isinstance(tree, ParamSpec):
            return _leaf(tree, seed, path, jobs)
        return {k: mk(v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    tree = mk(schema(cfg), "")
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for done in [pool.submit(job) for job in jobs]:
            done.result()
    return tree
