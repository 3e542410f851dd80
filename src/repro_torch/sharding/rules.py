"""Logical-axis -> mesh-axis rule engine (the port's copy of
``repro.sharding.rules``).

Every parameter carries logical axis names from the schema; every
activation hint (``shard_hint``) names a layout point. Rules resolve both
to specs with *divisibility checks*: a mapping that does not divide
evenly falls back down a candidate list (ending in replication), so every
arch lays out on every mesh, and every shard is even.

A spec is a tuple with one entry per tensor dim, each ``None``, a mesh
axis name, or a tuple of names used jointly (FSDP's ``("pod", "data")``):
the shape of a ``PartitionSpec``. ``ShardingRules.placements`` turns one
into ``torch.distributed.tensor`` placements over the rules' mesh, and
``named`` pairs the two as a :class:`NamedSharding`; ``distribute`` and
``local_part`` place a full tensor by one.

The rules read only the mesh's axis names and sizes
(``mesh.mesh_dim_names``, ``mesh.shape``), so they can be built over a
stand-in of any size without its processes. The MeshPlanner mutates a
:class:`ShardingRules` (its DSE knobs); this module is data-driven for
that reason.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.models.config import ModelConfig

# candidate mesh axes per logical axis, in preference order. Each entry is a
# tuple of mesh-axis names to use jointly (e.g. FSDP over ("pod","data")).
DEFAULT_PARAM_RULES: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "vocab":   (("model",),),
    "ffn":     (("model",),),
    "qkv":     (("model",),),
    "kv":      (("model",),),
    "experts": (("model",),),
    "embed":   (),                       # replicated unless fsdp=True
}
FSDP_EMBED = (("pod", "data"), ("data",))

Spec = Tuple[object, ...]


class NamedSharding(NamedTuple):
    """A spec on a mesh, and the DTensor placements it stands for."""
    mesh: object
    spec: Spec
    placements: tuple


@dataclass
class ShardingRules:
    mesh: object                         # a DeviceMesh, or a stand-in
    # mesh axis names present (subset of pod/data/model)
    dp_axes: Tuple[str, ...] = ("pod", "data")
    tp_axis: str = "model"
    fsdp: bool = True                    # shard "embed" dims over dp axes
    seq_shard: bool = True               # sequence parallelism for activations
    seq_attn_min_s: int = 16384          # min S for seq-parallel attention
    param_rules: Dict[str, Tuple[Tuple[str, ...], ...]] = field(
        default_factory=lambda: dict(DEFAULT_PARAM_RULES))

    def __post_init__(self):
        names = tuple(self.mesh.mesh_dim_names)
        self.dp_axes = tuple(a for a in self.dp_axes if a in names)
        self._sizes = dict(zip(names, (int(n) for n in self.mesh.shape)))

    # -- helpers ------------------------------------------------------------
    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self._sizes[a] for a in axes) if axes else 1

    def _fits(self, dim: int, axes: Sequence[str], used: set) -> bool:
        return bool(axes and not (set(axes) & used)
                    and all(a in self._sizes for a in axes)
                    and dim % self.axes_size(axes) == 0)

    def _dp_if(self, b: int):
        """The dp axes for a leading dim of ``b`` rows, None unless they
        divide it."""
        dp = self.dp_axes
        dp_n = self.axes_size(dp)
        if dp and b % dp_n == 0 and b >= dp_n:
            return dp if len(dp) > 1 else dp[0]
        return None

    # -- params -------------------------------------------------------------
    def param_spec(self, shape: Tuple[int, ...],
                   logical: Tuple[object, ...]) -> Spec:
        used: set = set()
        out = []
        for dim, name in zip(shape, logical):
            cands: Tuple[Tuple[str, ...], ...] = ()
            if name is not None:
                cands = tuple(self.param_rules.get(name, ()))
                if name == "embed" and self.fsdp:
                    cands = cands + FSDP_EMBED
            chosen = None
            for axes in cands:
                if self._fits(dim, axes, used):
                    chosen = axes
                    break
            if chosen:
                used.update(chosen)
                out.append(chosen if len(chosen) > 1 else chosen[0])
            else:
                out.append(None)
        return tuple(out)

    # -- activations ----------------------------------------------------------
    def activation_spec(self, kind: str,
                        shape: Tuple[int, ...]) -> Optional[Spec]:
        """The spec of an activation hint, or None (no constraint)."""
        tp_n = self._sizes.get(self.tp_axis, 1)
        dp_if = self._dp_if

        if kind == "acts":               # (B, S, D)
            b, s, d = shape
            sp = self.tp_axis if (self.seq_shard and s % tp_n == 0
                                  and s >= tp_n) else None
            return (dp_if(b), sp, None)
        if kind == "acts_ffn":           # (B, S, Dff) - recurrent widths
            b, s, d = shape
            tp = self.tp_axis if d % tp_n == 0 else None
            return (dp_if(b), None, tp)
        if kind == "logits":             # (B, S, V) or (B, V)
            v = shape[-1]
            tp = self.tp_axis if v % tp_n == 0 else None
            return (dp_if(shape[0]), *([None] * (len(shape) - 2)), tp)
        if kind == "heads":              # (B, S, H, hd) pre-attention
            b, s, h, _ = shape
            if h % tp_n == 0 and h >= tp_n:
                return (dp_if(b), None, self.tp_axis, None)
            if self.seq_shard and s % tp_n == 0 \
                    and s >= self.seq_attn_min_s:
                # head counts below or indivisible by the axis (40, 15,
                # 10): sequence-parallel attention at long context only
                return (dp_if(b), self.tp_axis, None, None)
            return (dp_if(b), None, None, None)
        if kind == "expert_buf":         # (E, C, D)
            e = shape[0]
            tp = self.tp_axis if e % tp_n == 0 else None
            return (tp, None, None)
        if kind == "expert_buf4":        # (B, E, C, D) grouped dispatch
            b, e = shape[0], shape[1]
            tp = self.tp_axis if e % tp_n == 0 else None
            return (dp_if(b), tp, None, None)
        if kind == "kv_cache":           # (B, S, Hkv, hd)
            b, s, h, _hd = shape
            if h % tp_n == 0:            # prefer head sharding
                return (dp_if(b), None, self.tp_axis, None)
            if s % tp_n == 0 and s >= tp_n:
                # GQA head counts below the axis size: shard the sequence
                return (dp_if(b), self.tp_axis, None, None)
            return (dp_if(b), None, None, None)
        if kind == "tokens":             # (B, S)
            return (dp_if(shape[0]), None)
        if kind == "launch":             # (N, ...) batched G-GPU launches
            return (dp_if(shape[0]), *([None] * (len(shape) - 1)))
        return None

    # -- DTensor placements ---------------------------------------------------
    def placements(self, spec: Spec) -> tuple:
        """The DTensor placements of ``spec`` on the rules' mesh: a tensor
        dim mapped to one mesh axis is ``Shard(dim)`` on that mesh dim, a
        dim mapped to a tuple of axes ``Shard(dim)`` on each of them (in
        the tuple's order, which must be the mesh's: DTensor splits over
        mesh dims major to minor, as a PartitionSpec splits over its
        tuple), every other mesh dim ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry!r} is not in the "
                                 f"mesh's axis order {names}")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)

    def named(self, spec: Spec) -> NamedSharding:
        return NamedSharding(self.mesh, tuple(spec), self.placements(spec))


def make_rules(mesh, **kw) -> ShardingRules:
    return ShardingRules(mesh=mesh, **kw)


# ---------------------------------------------------------------------------
# shardings of params / optimizer / inputs / caches
# ---------------------------------------------------------------------------

def param_shardings(rules: ShardingRules,
                    cfg: ModelConfig) -> Dict[str, NamedSharding]:
    """{the port's parameter name: its NamedSharding}. A layer's
    parameter takes the reference's stacked leaf's spec without its
    leading None (``schema.named_specs``)."""
    from repro_torch.models.schema import named_specs
    return {n: rules.named(rules.param_spec(s.shape, s.axes))
            for n, s in named_specs(cfg).items()}


def opt_state_shardings(rules: ShardingRules, cfg: ModelConfig):
    """The AdamW state's shardings: both moments as the parameters, the
    step count replicated."""
    from repro_torch.optim.adamw import AdamWState
    ps = param_shardings(rules, cfg)
    return AdamWState(m=ps, v=ps, step=rules.named(()))


def input_shardings(rules: ShardingRules, batch_tree):
    """Shard batch inputs: leading dim over dp when divisible (tokens,
    embeds, labels, and M-RoPE's (3, B, S) positions by their stream
    axis, as the reference lays them out)."""
    def spec(arr):
        return rules.named((rules._dp_if(arr.shape[0]),
                            *([None] * (arr.ndim - 1))))
    return _tree_map(spec, batch_tree)


def cache_shardings(rules: ShardingRules, cache_tree):
    """Shard decode caches: batch over dp, kv-heads over model if
    divisible. The port's caches hold one entry per layer where the
    reference stacks each group's repeats, so each leaf takes the
    reference's rule for the stacked leaf ``(reps, *shape)`` without its
    leading None: a 4-D leaf (a KV cache's (B, S, Hkv, hd), or an mLSTM's
    (B, H, hd, hd) matrix memory, as in the reference) the ``kv_cache``
    rule, any other leaf of ndim >= 1 (a recurrent state, (B, ...)) its
    batch over dp."""
    def spec(arr):
        if arr.ndim >= 4:
            return rules.named(rules.activation_spec("kv_cache",
                                                     tuple(arr.shape[:4]))
                               + (None,) * (arr.ndim - 4))
        if arr.ndim >= 1:
            return rules.named((rules._dp_if(arr.shape[0]),
                                *([None] * (arr.ndim - 1))))
        return rules.named(())
    return _tree_map(spec, cache_tree)


def _tree_map(fn, tree):
    """``fn`` over the leaves (anything with a ``shape``) of nested dicts,
    lists, tuples and NamedTuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


# ---------------------------------------------------------------------------
# placing full tensors
# ---------------------------------------------------------------------------

def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: the current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_part(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements`` on ``mesh``: a
    view, cut over each sharded mesh dim, major to minor, at this rank's
    coordinate (every split divides: the rules choose only such splits).
    The whole tensor, not a copy, where no mesh dim of extent > 1 shards
    it."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    out = full
    for i, pl in enumerate(placements):
        n = mesh.size(i)
        if isinstance(pl, Shard) and n > 1:
            size = out.shape[pl.dim] // n
            out = out.narrow(pl.dim, coord[i] * size, size)
    return out


def is_whole(mesh, placements) -> bool:
    """Whether every rank holds the whole tensor under ``placements``."""
    from torch.distributed.tensor import Shard
    return not any(isinstance(pl, Shard) and mesh.size(i) > 1
                   for i, pl in enumerate(placements))


def distribute(full: torch.Tensor, sharding: NamedSharding):
    """``full`` (the same on every rank) as a DTensor placed by
    ``sharding``, without communication: each rank keeps its block, a
    copy of it, or ``full`` itself (no copy) where the block is whole."""
    from torch.distributed.tensor import DTensor
    mesh, placements = sharding.mesh, sharding.placements
    if is_whole(mesh, placements):
        local = full
    else:
        local = local_part(full, mesh, placements).clone(
            memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())
