"""AdamW with decoupled weight decay (the port's ``repro.optim.adamw``).

Written as the reference writes it, which ``torch.optim.AdamW`` and
``clip_grad_norm_`` are not: the clip scale is ``min(1, clip /
max(gnorm, 1e-12))`` (not ``clip / (norm + 1e-6)``), bias correction
raises the betas to the step as f32, and weight decay applies only to
tensors of ndim >= 2 and sits inside the update ``delta``. Parameters,
grads and the moments are dicts {name: tensor}; ``update`` works in place
on the parameters and the state with ``torch._foreach_*`` ops, one
rounding per operation of the reference's, and keeps every scalar on the
device (no host sync).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor            # 0-dim int32, updated in place


def schedule(hp: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (f32)."""
    step = step.float()
    warm = torch.clamp(step / max(hp.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - hp.warmup_steps)
                       / max(hp.total_steps - hp.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return hp.lr * warm * (hp.min_lr_frac + (1 - hp.min_lr_frac) * cos)


def init(params: Dict[str, torch.Tensor]) -> AdamWState:
    """Zero moments of each parameter's dtype and device, step 0."""
    zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa
    dev = next(iter(params.values())).device
    return AdamWState(zeros(), zeros(),
                      torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of each one's sum of squares, in f32.
    Not ``torch._foreach_norm`` or ``linalg.vector_norm``: on the CPU they
    accumulate one tensor's squares in f32 in order, which drifts over
    the 47M elements of SmolLM's embedding, where ``sum`` sums
    pairwise."""
    return torch.sqrt(torch.stack([t.float().square().sum()
                                   for t in tensors]).sum())


def bias_corrections(hp: AdamWConfig, step: torch.Tensor):
    """(1 - b1^step, 1 - b2^step), the step as f32."""
    t = step.float()
    return 1 - torch.pow(hp.b1, t), 1 - torch.pow(hp.b2, t)


@torch.no_grad()
def update(grads: Dict[str, torch.Tensor], state: AdamWState,
           params: Dict[str, torch.Tensor], hp: AdamWConfig,
           ndims: Optional[Dict[str, int]] = None,
           gnorm: Optional[torch.Tensor] = None) -> dict:
    """One AdamW step in place on ``params`` and ``state``. ``ndims``
    ({name: ndim}) is what the decay rule reads, each tensor's own ndim
    where not given (see ``models.model.decay_ndims``). ``gnorm`` is the
    clip's global norm, that of ``grads`` where not given: a sharded step
    passes each rank's shards of the parameters, moments and gradients,
    and the norm of the whole gradients. Returns the metrics
    {"grad_norm", "lr"} as 0-dim f32 tensors."""
    names = list(params)
    state.step.add_(1)
    step = state.step
    if gnorm is None:
        gnorm = global_norm(grads[n] for n in names)
    lr = schedule(hp, step)
    b1c, b2c = bias_corrections(hp, step)
    g = [grads[n].float() for n in names]
    if hp.grad_clip > 0:
        scale = torch.clamp(hp.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        g = torch._foreach_mul(g, scale)
    m = [state.m[n] for n in names]
    v = [state.v[n] for n in names]
    p = [params[n] for n in names]
    # m = b1 * m + (1 - b1) * g ; v = b2 * v + (1 - b2) * g^2
    torch._foreach_mul_(m, hp.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - hp.b1))
    g2 = torch._foreach_mul(g, g)
    torch._foreach_mul_(g2, 1 - hp.b2)
    torch._foreach_mul_(v, hp.b2)
    torch._foreach_add_(v, g2)
    del g, g2
    # delta = (m / b1c) / (sqrt(v / b2c) + eps) [+ wd * p]
    delta = torch._foreach_div(m, b1c)
    denom = torch._foreach_div(v, b2c)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, hp.eps)
    torch._foreach_div_(delta, denom)
    del denom
    ndims = ndims or {}
    decay = [i for i, n in enumerate(names)
             if ndims.get(n, params[n].ndim) >= 2]   # decay matrices only
    if decay:
        torch._foreach_add_([delta[i] for i in decay], torch._foreach_mul(
            [p[i].float() for i in decay], hp.weight_decay))
    # p = p - lr * delta
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(p, delta)
    return {"grad_norm": gnorm, "lr": lr}
