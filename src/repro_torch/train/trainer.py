"""Fault-tolerant training loop (the port's ``repro.train.trainer``).

Responsibilities:
  * auto-resume from the newest complete checkpoint (params, optimizer,
    step): kill the process at any point and re-run the same command;
  * periodic atomic checkpoints (``save_every``) and a final one;
  * deterministic data: batch = f(seed, step), so an interrupted-and-
    resumed run is bit-identical to an uninterrupted one on the CPU
    (tested), and on the card where its kernels are deterministic;
  * straggler/failure hooks: a per-step wall-time watchdog that logs
    outliers, and an injectable failure for tests (``fail_at_step``).

Parameters start from ``schema.init_numpy(cfg, seed)``, on one device
(the card unless the caller asks for another), or with ``rules``
(``sharding.rules``) placed on their mesh as the reference's Trainer
places them: parameters by ``param_shardings`` and AdamW's state by
``opt_state_shardings``, as DTensors (``models.steps.shard_state``);
resume restores the checkpoint onto those shardings, every step runs the
sharded step under ``set_rules``, and the metrics are the global ones.
Each rank builds the global batch (``host_count=1``) and keeps its rows
(``data.pipeline.device_put_batch``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import _device
from repro_torch.convert import init_model
from repro_torch.data.pipeline import DataConfig, device_put_batch, \
    make_source
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.models.steps import bind_shards, gather_params, \
    make_train_step, shard_state
from repro_torch.optim import adamw
from repro_torch.sharding import set_rules
from repro_torch.sharding.rules import input_shardings, mesh_device, \
    opt_state_shardings, param_shardings
from repro_torch.train import checkpoint


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    save_every: int = 50
    log_every: int = 10
    seed: int = 0
    microbatches: int = 1
    ckpt_dir: str = "checkpoints"
    straggler_factor: float = 3.0     # log steps slower than 3x median
    fail_at_step: int = -1            # test hook: raise at this step


class Trainer:
    def __init__(self, cfg: ModelConfig, hp: adamw.AdamWConfig,
                 tc: TrainConfig, data_cfg: DataConfig, device=None,
                 rules=None):
        if rules is not None and data_cfg.host_count != 1:
            raise ValueError("a sharded Trainer reads the global batch: "
                             "data_cfg.host_count must be 1")
        self.cfg, self.hp, self.tc, self.rules = cfg, hp, tc, rules
        self.device = (_device.resolve(device) if rules is None
                       else mesh_device(rules.mesh))
        self.data = make_source(data_cfg)
        self.step_fn = make_train_step(cfg, hp, microbatches=tc.microbatches,
                                       rules=rules)
        self.metrics_log = []

    # -- state ---------------------------------------------------------------
    def init_state(self):
        """(model, params, opt, step): ``params`` is what AdamW updates,
        the model's own parameters, or their shards under rules."""
        model = init_model(self.cfg, self.tc.seed, self.device)
        model.requires_grad_(True)
        if self.rules is not None:
            params, opt = shard_state(model, self.rules, self.cfg)
            bind_shards(model, params, self.rules,
                        param_shardings(self.rules, self.cfg))
            return model, params, opt, 0
        params = dict(model.named_parameters())
        return model, params, adamw.init(params), 0

    def resume_or_init(self):
        last = checkpoint.latest_step(self.tc.ckpt_dir)
        if last is None:
            return self.init_state()
        shard = opt_shard = None
        if self.rules is not None:
            shard = param_shardings(self.rules, self.cfg)
            opt_shard = opt_state_shardings(self.rules, self.cfg)
        params, opt, _ = checkpoint.restore(self.tc.ckpt_dir, last,
                                            self.device, shard, opt_shard)
        model = LM(self.cfg, self.device)
        own = dict(model.named_parameters())
        if set(own) != set(params):
            raise KeyError(f"checkpoint step {last}: parameters "
                           f"{sorted(set(own) ^ set(params))} do not match "
                           f"{self.cfg.name}")
        opt = adamw.AdamWState(**opt)
        if self.rules is not None:
            bind_shards(model, params, self.rules, shard)
        else:
            with torch.no_grad():
                for name, p in own.items():
                    p.copy_(params[name])
            params = own
        model.requires_grad_(True)
        print(f"[trainer] resumed from step {last}")
        return model, params, opt, last

    # -- loop ----------------------------------------------------------------
    def run(self) -> Dict:
        """Train to ``tc.steps``. Returns the final loss, the model (its
        parameters in full on every rank), ``params`` (what AdamW
        updated) and ``opt``."""
        model, params, opt, start = self.resume_or_init()
        with set_rules(self.rules):
            self._loop(model, params, opt, start)
        if self.rules is not None:
            gather_params(model, params)
        final_loss = self.metrics_log[-1]["loss"] if self.metrics_log \
            else math.nan
        return {"final_loss": final_loss, "steps": self.tc.steps,
                "model": model, "params": params, "opt": opt}

    def put_batch(self, step: int):
        """The batch of ``step`` on the device, laid out by the rules'
        ``input_shardings`` under them."""
        batch = self.data.batch_at(step)
        shardings = (None if self.rules is None
                     else input_shardings(self.rules, batch))
        return device_put_batch(batch, shardings, self.device)

    def step(self, model, params, opt, batch) -> Dict:
        """One train step on the state ``resume_or_init`` returns."""
        if self.rules is None:
            return self.step_fn(model, opt, batch)
        return self.step_fn(model, opt, batch, params)

    def _loop(self, model, params, opt, start: int) -> None:
        durations = []
        for step in range(start, self.tc.steps):
            if step == self.tc.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.time()
            metrics = self.step(model, params, opt, self.put_batch(step))
            loss = float(metrics["loss"])
            dt = time.time() - t0
            durations.append(dt)
            med = float(np.median(durations[-50:]))
            if dt > self.tc.straggler_factor * med and len(durations) > 5:
                print(f"[trainer] straggler: step {step} took {dt:.2f}s "
                      f"(median {med:.2f}s)")
            if (step + 1) % self.tc.log_every == 0 or step == start:
                print(f"[trainer] step {step + 1}: loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"({dt:.2f}s)")
            self.metrics_log.append({"step": step + 1, "loss": loss,
                                     "seconds": dt})
            if (step + 1) % self.tc.save_every == 0 \
                    or step + 1 == self.tc.steps:
                checkpoint.save(self.tc.ckpt_dir, step + 1, params, opt,
                                {"arch": self.cfg.name})
