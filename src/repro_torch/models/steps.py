"""Step factories (the port's ``repro.models.steps``).

``make_train_step(cfg, hp, microbatches)`` returns
``train_step(model, opt_state, batch) -> metrics``: gradients of the loss
(accumulated in f32 over ``microbatches`` slices of the batch and divided
by their number), then ``adamw.update``, both in place on the model's
parameters and ``opt_state``. Metrics are 0-dim tensors: ``loss``,
``grad_norm`` and ``lr``.

``make_prefill_step`` / ``make_decode_step`` are the serving entry points,
``make_encode_step`` the encoder-only one (HuBERT).
PyTorch runs eagerly, so a step is the function itself, with no ``jit``.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def make_loss_fn(cfg: ModelConfig):
    def loss(model, batch):
        return M.loss_fn(model, cfg, batch)
    return loss


def make_train_step(cfg: ModelConfig, hp: adamw.AdamWConfig,
                    microbatches: int = 1):
    loss_fn = make_loss_fn(cfg)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        model.zero_grad()
        if microbatches > 1:
            # grads accumulate in the parameters' .grad (f32 leaves), as
            # the reference sums each slice's grads onto f32 zeros
            lsum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            for i in range(microbatches):
                mbatch = {k: _microbatch(k, v, i, microbatches)
                          for k, v in batch.items()}
                mb_loss = loss_fn(model, mbatch)
                mb_loss.backward()
                lsum = lsum + mb_loss.detach()
            loss = lsum / microbatches
            grads = {n: _grad(p) / microbatches for n, p in params.items()}
        else:
            loss = loss_fn(model, batch)
            loss.backward()
            grads = {n: _grad(p) for n, p in params.items()}
        metrics = adamw.update(grads, opt_state, params, hp,
                               ndims=M.decay_ndims(model))
        return dict(metrics, loss=loss.detach())

    return train_step


def _grad(p):
    """A parameter's gradient; zeros for one the loss does not reach (a
    token model's ``frontend_proj``, a frame model's ``embed``), which
    the reference's ``value_and_grad`` also gives, and AdamW decays."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _microbatch(key: str, x, i: int, microbatches: int):
    """The i-th of ``microbatches`` slices of a batch entry along its
    batch axis: axis 1 of M-RoPE's (3, B, S) positions, else axis 0."""
    ax = 1 if key == "positions" and x.ndim == 3 and x.shape[0] == 3 else 0
    mb = x.shape[ax] // microbatches
    return x.narrow(ax, i * mb, mb)


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        return M.prefill(model, cfg, tokens=batch.get("tokens"),
                         embeds=batch.get("embeds"),
                         positions=batch.get("positions"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(model, cache, token, pos):
        return M.decode_step(model, cfg, cache, token, pos)
    return decode_step


def make_encode_step(cfg: ModelConfig):
    def encode_step(model, batch):
        return M.encode(model, cfg, embeds=batch["embeds"])
    return encode_step
