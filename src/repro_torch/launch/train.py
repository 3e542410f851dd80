"""Distributed training launcher: mesh + sharding rules + the
fault-tolerant trainer, end to end (the port's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --full-config --steps 12 --seq-len 2048 --batch 8
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --steps 3

As the reference's ``main``: the squarest (data, model) mesh over the
world it was started in (``launch.mesh.build_mesh``), the rules
``make_rules(mesh)`` with their defaults, MeshPlanner's plan for that
mesh (``n_devices`` the world, ``tp`` the model extent), whose knobs set
only what ``Knobs.apply`` sets (the remat policy, attention chunks and
``use_kernels``, off: the kernels have no backward), and the Trainer
with ``rules=``. Started by ``torchrun``, it reads the world from the
environment; started alone, it opens a world of one (NCCL on the card,
gloo with ``--device cpu``) and closes it on return. An existing process
group is left as found. On one card the world is one: NCCL refuses two
ranks on one device.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch import _device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.meshplanner import plan
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import build_mesh
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import adamw
from repro_torch.sharding.rules import make_rules
from repro_torch.train.trainer import Trainer, TrainConfig


def open_world(device: torch.device) -> bool:
    """Open the process group unless one is open: from ``torchrun``'s
    environment when it set one, else a world of one. NCCL on the card,
    gloo on the CPU. Returns whether it opened one."""
    if dist.is_initialized():
        return False
    kw = {"backend": "gloo"}
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        kw = {"backend": "nccl",
              "device_id": torch.device("cuda", torch.cuda.current_device())}
    if "WORLD_SIZE" not in os.environ:
        kw.update(store=dist.HashStore(), rank=0, world_size=1)
    dist.init_process_group(**kw)
    return True


def main(argv=None) -> dict:
    """Parse ``argv`` (the command line when None), plan and train.
    Returns the trainer's result with the ``plan``, the ``microbatches``
    used and the ``trainer`` itself."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--full-config", action="store_true",
                    help="the published size (default: the SMOKE config)")
    ap.add_argument("--layers", type=int, default=0,
                    help="the config's first N layers, widths unchanged "
                         "(0 = all of them)")
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
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    device = _device.resolve(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "the CPU")
    print(f"device: {device} ({name})")
    opened = open_world(device)
    try:
        mesh = build_mesh()
        rules = make_rules(mesh)
        world = dist.get_world_size()
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"({world} devices)")

        # plan the launch like the dry-run plans a cell, for this mesh
        shape = ShapeSpec("launch", args.seq_len, args.batch, "train")
        mp = plan(cfg, shape, n_devices=world, tp=mesh.shape[-1])
        mb = args.microbatches or mp.knobs.microbatches
        cfg = mp.knobs.apply(cfg)
        print(f"plan: remat={cfg.remat} microbatches={mb} "
              f"est={mp.estimate.total_bytes / 2**30:.2f} GiB/dev "
              f"bound={mp.estimate.bound()}")

        hp = adamw.AdamWConfig(lr=args.lr,
                               warmup_steps=max(2, args.steps // 10),
                               total_steps=args.steps)
        tc = TrainConfig(steps=args.steps,
                         save_every=max(10, args.steps // 4), log_every=10,
                         ckpt_dir=args.ckpt_dir, microbatches=mb)
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                        global_batch=args.batch)
        trainer = Trainer(cfg, hp, tc, dc, rules=rules)
        result = trainer.run()
    finally:
        if opened:
            dist.destroy_process_group()
    print(f"final loss: {result['final_loss']:.4f}")
    return {"plan": mp, "microbatches": mb, "trainer": trainer,
            "mesh": mesh, "rules": rules, **result}


if __name__ == "__main__":
    main()
