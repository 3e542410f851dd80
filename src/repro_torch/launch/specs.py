"""Meta-device stand-ins for every dry-run cell, no memory allocated (the
port's ``repro.launch.specs``).

``input_specs(cfg, shape, rules)`` returns the step's inputs as DTensors
on the ``meta`` device, each placed by the sharding rules, its local
block of this rank's shape:
  train   -> (params, opt_state, batch)
  prefill -> (params, batch)
  decode  -> (params, cache, token, pos)
``params`` is {the port's parameter name: tensor} (a layer's parameter is
the reference's stacked leaf without its repeats dim), ``opt_state`` an
``AdamWState``, ``cache`` the port's per-layer list (``init_cache``).
``input_layout`` is the same trees before placing, each beside its tree
of ``NamedSharding``s: it reads only the rules' axis names and sizes, so
it runs over a stand-in mesh of any size.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.models.layers import pdt
from repro_torch.models.model import init_cache
from repro_torch.models.schema import named_specs
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding.rules import (NamedSharding, ShardingRules,
                                        cache_shardings, distribute,
                                        input_shardings, opt_state_shardings,
                                        param_shardings)

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """{parameter name: meta tensor} of ``cfg``'s parameters."""
    return {n: _meta(s.shape, pdt(cfg)) for n, s in named_specs(cfg).items()}


def abstract_batch(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta train/prefill batch (tokens or frontend embeds)."""
    b, s = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    if cfg.frontend:
        batch["embeds"] = _meta((b, s, cfg.d_frontend), torch.bfloat16)
        batch["labels"] = _meta((b, s), torch.int32)
        if cfg.mrope:
            batch["positions"] = _meta((3, b, s), torch.int32)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
        if shape.kind == "train":
            # labels come shifted from the data pipeline, so the model
            # sees the whole power-of-two seq_len, as in the reference
            batch["labels"] = _meta((b, s), torch.int32)
    return batch


def abstract_cache(cfg: ModelConfig, shape: ShapeSpec):
    """Meta decode cache of capacity seq_len."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, META)


def input_layout(cfg: ModelConfig, shape: ShapeSpec, rules: ShardingRules
                 ) -> Tuple[Tuple[Any, Any], ...]:
    """The step's inputs as (meta tree, tree of NamedShardings) pairs, in
    ``input_specs``'s order."""
    params = (abstract_params(cfg), param_shardings(rules, cfg))
    if shape.kind in ("train", "prefill"):
        batch = abstract_batch(cfg, shape)
        batch = (batch, input_shardings(rules, batch))
        if shape.kind == "prefill":
            return params, batch
        opt = AdamWState(m=abstract_params(cfg), v=abstract_params(cfg),
                         step=_meta((), torch.int32))
        return params, (opt, opt_state_shardings(rules, cfg)), batch
    if shape.kind == "decode":
        cache = abstract_cache(cfg, shape)
        b = shape.global_batch
        token = (_meta((b, 1), torch.int32),
                 rules.named(rules.activation_spec("tokens", (b, 1))))
        pos = (_meta((), torch.int32), rules.named(()))
        return params, (cache, cache_shardings(rules, cache)), token, pos
    raise ValueError(shape.kind)


def _zip_map(fn, tree, shardings):
    """``fn(leaf, sharding)`` over a tree (dicts, lists, tuples and
    NamedTuples of tensors) and its tree of NamedShardings."""
    if isinstance(shardings, NamedSharding):
        return fn(tree, shardings)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, s)
                            for v, s in zip(tree, shardings)))
    return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, shardings))


def input_specs(cfg: ModelConfig, shape: ShapeSpec, rules: ShardingRules
                ) -> Tuple[Any, ...]:
    """The step's inputs as meta DTensors on the rules' mesh (which needs
    an initialised process group; placing moves nothing)."""
    return tuple(_zip_map(distribute, tree, shardings)
                 for tree, shardings in input_layout(cfg, shape, rules))
