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

Parameters start from ``schema.init_numpy(cfg, seed)``. One device, the
card unless the caller asks for another; sharded training is not ported
(ROADMAP.md, queue item 9).
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
from repro_torch.data.pipeline import DataConfig, make_source, to_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw
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
                 tc: TrainConfig, data_cfg: DataConfig, device=None):
        self.cfg, self.hp, self.tc = cfg, hp, tc
        self.device = _device.resolve(device)
        self.data = make_source(data_cfg)
        self.step_fn = make_train_step(cfg, hp,
                                       microbatches=tc.microbatches)
        self.metrics_log = []

    # -- state ---------------------------------------------------------------
    def init_state(self):
        model = init_model(self.cfg, self.tc.seed, self.device)
        model.requires_grad_(True)
        return model, adamw.init(dict(model.named_parameters())), 0

    def resume_or_init(self):
        last = checkpoint.latest_step(self.tc.ckpt_dir)
        if last is None:
            return self.init_state()
        params, opt, _ = checkpoint.restore(self.tc.ckpt_dir, last,
                                            self.device)
        model = LM(self.cfg, self.device)
        own = dict(model.named_parameters())
        if set(own) != set(params):
            raise KeyError(f"checkpoint step {last}: parameters "
                           f"{sorted(set(own) ^ set(params))} do not match "
                           f"{self.cfg.name}")
        with torch.no_grad():
            for name, p in own.items():
                p.copy_(params[name])
        model.requires_grad_(True)
        print(f"[trainer] resumed from step {last}")
        return model, adamw.AdamWState(**opt), last

    # -- loop ----------------------------------------------------------------
    def run(self) -> Dict:
        model, opt, start = self.resume_or_init()
        durations = []
        for step in range(start, self.tc.steps):
            if step == self.tc.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.time()
            batch = to_device(self.data.batch_at(step), self.device)
            metrics = self.step_fn(model, opt, batch)
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
                checkpoint.save(self.tc.ckpt_dir, step + 1,
                                dict(model.named_parameters()), opt,
                                {"arch": self.cfg.name})
        final_loss = self.metrics_log[-1]["loss"] if self.metrics_log \
            else math.nan
        return {"final_loss": final_loss, "steps": self.tc.steps,
                "model": model, "opt": opt}
