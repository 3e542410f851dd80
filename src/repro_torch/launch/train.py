"""Training launcher on one card: MeshPlanner's plan, then the
fault-tolerant trainer, end to end (the port's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --full-config --steps 12 --seq-len 2048 --batch 8

MeshPlanner picks the remat policy and microbatches for the configured
shape before the first step (spec -> map -> run, the GPUPlanner flow);
the plan's knobs set the config's (``use_kernels`` off: the kernels have
no backward). Runs on the card unless ``--device`` names another; there
is no ``--mesh`` (sharded training: ROADMAP.md, queue item 9).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import _device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.meshplanner import plan
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainConfig


def main(argv=None) -> dict:
    """Parse ``argv`` (the command line when None), plan and train.
    Returns the trainer's result with the ``plan``, the ``microbatches``
    used and the ``trainer`` itself."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--full-config", action="store_true",
                    help="the published size (default: the SMOKE config)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = let MeshPlanner decide")
    ap.add_argument("--ckpt-dir", default="checkpoints/launch_train")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full_config else get_smoke(args.arch)
    device = _device.resolve(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "the CPU")
    print(f"device: {device} ({name})")

    # plan the launch like the dry-run plans a cell, for one card
    shape = ShapeSpec("launch", args.seq_len, args.batch, "train")
    mp = plan(cfg, shape)
    mb = args.microbatches or mp.knobs.microbatches
    cfg = mp.knobs.apply(cfg)
    print(f"plan: remat={cfg.remat} microbatches={mb} "
          f"est={mp.estimate.total_bytes / 2**30:.2f} GiB/dev "
          f"bound={mp.estimate.bound()}")

    hp = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                           total_steps=args.steps)
    tc = TrainConfig(steps=args.steps, save_every=max(10, args.steps // 4),
                     log_every=10, ckpt_dir=args.ckpt_dir, microbatches=mb)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.batch)
    trainer = Trainer(cfg, hp, tc, dc, device)
    result = trainer.run()
    print(f"final loss: {result['final_loss']:.4f}")
    return {"plan": mp, "microbatches": mb, "trainer": trainer, **result}


if __name__ == "__main__":
    main()
