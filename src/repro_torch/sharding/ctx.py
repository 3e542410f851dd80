"""Ambient sharding context (the port's ``repro.sharding.ctx``).

Model code calls ``shard_hint(x, kind)`` at layout-critical points; what
that means is decided by the active :class:`ShardingRules` (set by the
Trainer). With no rules set, or on a plain tensor, hints are the
identity, so model code never depends on a mesh being present. The
sharded train step computes on plain tensors (``models.steps``), so its
hints change nothing; a ``DTensor`` is redistributed to the kind's spec.

``split_rows`` is the sharded step's note that each rank computes on its
own rows of the batch, split over the rules' dp axes; ``batch_mean``
takes a mean over those rows across the ranks (the MoE FFN's
load-balancing fractions, ``models.moe``), and is the identity outside
it.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def current_rules():
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def set_rules(rules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def shard_hint(x, kind: str):
    """Redistribute a DTensor ``x`` to the spec of activation ``kind`` if
    rules are active and give one; otherwise the identity."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = rules.activation_spec(kind, tuple(x.shape))
    if spec is None:
        return x
    return x.redistribute(rules.mesh, rules.placements(spec))


def dp_groups(rules):
    """The process groups of the rules' dp mesh dims of extent > 1, and
    the product of their extents."""
    mesh = rules.mesh
    names = tuple(mesh.mesh_dim_names)
    groups = [mesh.get_group(a) for a in rules.dp_axes
              if mesh.size(names.index(a)) > 1]
    return groups, rules.axes_size(rules.dp_axes)


@contextlib.contextmanager
def split_rows(rules):
    """Within the block, each rank's batch is its rows of the global
    batch, split over ``rules``' dp axes."""
    prev = getattr(_state, "rows", None)
    _state.rows = dp_groups(rules)
    try:
        yield
    finally:
        _state.rows = prev


class _BatchMean(torch.autograd.Function):
    """The mean over the dp ranks of ``x``, each rank's over its own,
    equally many, rows. Every rank then holds the global value and
    computes the same loss terms from it. Each rank's loss weighs its
    rows as if they were the whole batch, and the step averages the
    ranks' gradients; so the backward passes the gradient through as it
    is, which after that average is the one-device gradient."""

    @staticmethod
    def forward(ctx, x, groups, n):
        import torch.distributed as dist
        y = x.detach().clone()
        for group in groups:
            dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a mean over this rank's rows, as the mean over the global
    batch's rows inside ``split_rows``; ``x`` itself outside it."""
    rows = getattr(_state, "rows", None)
    if rows is None or not rows[0]:
        return x
    return _BatchMean.apply(x, *rows)
