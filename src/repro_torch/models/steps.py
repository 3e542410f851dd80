"""Step factories (the port's ``repro.models.steps``).

``make_train_step(cfg, hp, microbatches)`` returns
``train_step(model, opt_state, batch) -> metrics``: gradients of the loss
(accumulated in f32 over ``microbatches`` slices of the batch and divided
by their number), then ``adamw.update``, both in place on the model's
parameters and ``opt_state``. Metrics are 0-dim tensors: ``loss``,
``grad_norm`` and ``lr``.

With ``rules`` (``sharding.rules``), the step is the sharded one,
``train_step(model, opt_state, batch, params)``: ``params`` {name:
DTensor} and ``opt_state``'s moments are placed by the rules
(``shard_state``), and ``model`` is the compute copy. The arithmetic
stays on plain tensors, so the step computes what the one-device step
computes (the reference's GSPMD guarantee: only the layout changes):
  1. gather: each parameter whose shard is not the whole tensor is
     gathered in full into the model (``full_tensor``, exact);
  2. each rank runs the loss on its rows of microbatch i of the global
     batch: the rows split over the dp axes where they divide, as
     ``input_shardings`` lays the leading dim out (M-RoPE positions by
     their batch axis 1), else all of them;
  3. reduce: where the rows were split, the loss and gradients are
     averaged over the dp ranks (ranks along "model" share rows);
  4. the global norm of the whole gradients, then ``adamw.update`` on
     each rank's shards of the parameters, moments and gradients.
A mesh with data extent 1 is bit for bit the one-device step; above 1 the
gradient sums run in another order. Per-unit gathering and activation
sharding over "model" are not ported (ROADMAP.md, item 9c).

``make_prefill_step`` / ``make_decode_step`` are the serving entry points,
``make_encode_step`` the encoder-only one (HuBERT).
PyTorch runs eagerly, so a step is the function itself, with no ``jit``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import ctx
from repro_torch.sharding.rules import distribute, is_whole, local_part, \
    opt_state_shardings, param_shardings


def make_loss_fn(cfg: ModelConfig):
    def loss(model, batch):
        return M.loss_fn(model, cfg, batch)
    return loss


def _loss_and_grads(model, loss_fn, batches):
    """The mean loss over ``batches`` (the microbatches) and the mean
    gradients {name: tensor}."""
    params = dict(model.named_parameters())
    model.zero_grad()
    if len(batches) > 1:
        # grads accumulate in the parameters' .grad (f32 leaves), as
        # the reference sums each slice's grads onto f32 zeros
        lsum = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
        for mbatch in batches:
            mb_loss = loss_fn(model, mbatch)
            mb_loss.backward()
            lsum = lsum + mb_loss.detach()
        loss = lsum / len(batches)
        grads = {n: _grad(p) / len(batches) for n, p in params.items()}
    else:
        loss = loss_fn(model, batches[0])
        loss.backward()
        grads = {n: _grad(p) for n, p in params.items()}
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, hp: adamw.AdamWConfig,
                    microbatches: int = 1, rules=None):
    loss_fn = make_loss_fn(cfg)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        batches = [batch] if microbatches == 1 else [
            {k: _microbatch(k, v, i, microbatches) for k, v in batch.items()}
            for i in range(microbatches)]
        loss, grads = _loss_and_grads(model, loss_fn, batches)
        metrics = adamw.update(grads, opt_state, params, hp,
                               ndims=M.decay_ndims(model))
        return dict(metrics, loss=loss)

    def sharded_step(model, opt_state, batch, params):
        gather_params(model, params)
        batches = [{k: _rows(k, v, i, microbatches, rules)
                    for k, v in batch.items()}
                   for i in range(microbatches)]
        split = _split(batch, microbatches, rules)
        with ctx.split_rows(rules) if split else contextlib.nullcontext():
            loss, grads = _loss_and_grads(model, loss_fn, batches)
        if split:
            loss, grads = _dp_mean(loss, grads, rules)
        names = [n for n, _ in model.named_parameters()]
        with torch.no_grad():
            gnorm = adamw.global_norm(grads[n] for n in names)
            shards = {n: params[n].to_local() for n in names}
            local = {n: local_part(grads[n], params[n].device_mesh,
                                   params[n].placements) for n in names}
            state = adamw.AdamWState(
                {n: opt_state.m[n].to_local() for n in names},
                {n: opt_state.v[n].to_local() for n in names},
                opt_state.step.to_local())
        metrics = adamw.update(local, state, shards, hp,
                               ndims=M.decay_ndims(model), gnorm=gnorm)
        return dict(metrics, loss=loss)

    return train_step if rules is None else sharded_step


def _grad(p):
    """A parameter's gradient; zeros for one the loss does not reach (a
    token model's ``frontend_proj``, a frame model's ``embed``), which
    the reference's ``value_and_grad`` also gives, and AdamW decays."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _batch_axis(key: str, x) -> int:
    """Axis 1 of M-RoPE's (3, B, S) positions, else axis 0."""
    return 1 if key == "positions" and x.ndim == 3 and x.shape[0] == 3 \
        else 0


def _microbatch(key: str, x, i: int, microbatches: int):
    """The i-th of ``microbatches`` slices of a batch entry along its
    batch axis."""
    ax = _batch_axis(key, x)
    mb = x.shape[ax] // microbatches
    return x.narrow(ax, i * mb, mb)


# ---------------------------------------------------------------------------
# the sharded state and step
# ---------------------------------------------------------------------------

def shard_state(model, rules, cfg: ModelConfig):
    """(params {name: DTensor}, AdamWState of DTensors): ``model``'s
    parameters placed by ``param_shardings`` (a whole shard is the
    model's own tensor, not a copy) and zero moments by
    ``opt_state_shardings``, step 0."""
    ps = param_shardings(rules, cfg)
    os_ = opt_state_shardings(rules, cfg)
    with torch.no_grad():
        params = {n: distribute(p.detach(), ps[n])
                  for n, p in model.named_parameters()}
        zeros = lambda sh: {n: distribute(torch.zeros_like(p), sh[n])  # noqa
                            for n, p in model.named_parameters()}
        dev = next(model.parameters()).device
        opt = adamw.AdamWState(zeros(os_.m), zeros(os_.v), distribute(
            torch.zeros((), dtype=torch.int32, device=dev), os_.step))
    return params, opt


@torch.no_grad()
def bind(model, params) -> None:
    """Make each of ``model``'s parameters whose shard in ``params`` is
    the whole tensor that shard's storage (a restored state); the others
    are filled by ``gather_params``."""
    for name, p in model.named_parameters():
        shard = params[name]
        if is_whole(shard.device_mesh, shard.placements):
            p.data = shard.to_local()


@torch.no_grad()
def gather_params(model, params) -> None:
    """Each of ``model``'s parameters in full from its shard in
    ``params``: nothing to do where the model's tensor is the shard's
    storage, ``full_tensor`` (every rank takes part) elsewhere. Storages
    compare by identity, not by data pointer: on the meta device (the dry
    run) every pointer is 0."""
    for name, p in model.named_parameters():
        shard = params[name]
        if shard.to_local().untyped_storage()._cdata \
                != p.untyped_storage()._cdata:
            p.copy_(shard.full_tensor())


def _dp_index(rules):
    """(this rank's index among the dp ranks, their number)."""
    mesh = rules.mesh
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = 0
    for a in rules.dp_axes:
        i = names.index(a)
        idx = idx * mesh.size(i) + coord[i]
    return idx, rules.axes_size(rules.dp_axes)


def _split(batch, microbatches: int, rules) -> bool:
    """Whether each rank computes on its own rows: the dp axes have more
    than one rank and divide a microbatch's rows."""
    k, x = next(iter(batch.items()))
    rows = x.shape[_batch_axis(k, x)] // microbatches
    return rules.axes_size(rules.dp_axes) > 1 \
        and rules._dp_if(rows) is not None


def _rows(key: str, x, i: int, microbatches: int, rules):
    """This rank's rows of microbatch ``i`` of the global batch entry
    ``x`` (a DTensor from ``device_put_batch``, or a plain tensor that
    every rank holds in full)."""
    from torch.distributed.tensor import DTensor
    ax = _batch_axis(key, x)
    if isinstance(x, DTensor):
        lead = rules.placements((rules._dp_if(x.shape[0]),)
                                + (None,) * (x.ndim - 1))
        if microbatches == 1 and ax == 0 and tuple(x.placements) == lead:
            return x.to_local()             # laid out as its own rows
        x = x.full_tensor()
    part = _microbatch(key, x, i, microbatches)
    rows = part.shape[ax]
    if rules._dp_if(rows) is None:
        return part
    idx, n = _dp_index(rules)
    return part.narrow(ax, idx * (rows // n), rows // n)


def _dp_mean(loss, grads, rules):
    """The loss and gradients averaged over the dp ranks: one all-reduce
    over each dp mesh dim of a flat f32 buffer."""
    groups, n = ctx.dp_groups(rules)
    names = list(grads)
    flat = torch.cat([loss.reshape(1).float()]
                     + [grads[k].reshape(-1).float() for k in names])
    for group in groups:
        dist.all_reduce(flat, group=group)
    flat /= n
    out, at = {}, 1
    for k in names:
        g = grads[k]
        out[k] = flat[at:at + g.numel()].view(g.shape).to(g.dtype)
        at += g.numel()
    return flat[0], out


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
