"""End-to-end training script through the PyTorch port (``repro_torch``)
on one NVIDIA card: train a ~100M-class model for a few hundred steps
with checkpointing and resume.

    PYTHONPATH=src python examples/torch_train_lm.py --arch smollm-360m \
        --steps 300 --d-model 512 --layers 8 --ckpt-dir <dir>
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \
        --steps 4 --d-model 64 --layers 2 --heads 2 --seq-len 32 \
        --batch 4 --vocab 256 --ckpt-dir <dir>

Any assigned architecture id works (--arch); by default a width/depth-
reduced variant of it is trained. Training runs plain PyTorch (the
kernels have no backward). Kill it at any point and re-run: it resumes
from the last checkpoint in ``--ckpt-dir`` (the default is a fresh
temporary directory, so give one to resume). On the CPU a resumed run
equals an uninterrupted one bit for bit; on the card only where its
gradients are reproducible (embedding and index backward can be
nondeterministic there).
"""
import argparse
import contextlib
import tempfile

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh "
                         "temporary one, removed at the end)")
    ap.add_argument("--device", default=None,
                    help="where it runs (default: the card; 'cpu' for the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    base = get_config(args.arch)
    cfg = base.replace(
        n_layers=args.layers, d_model=args.d_model, n_heads=args.heads,
        n_kv_heads=max(1, args.heads // 2), d_ff=4 * args.d_model
        if base.d_ff else 0,
        vocab_size=args.vocab, head_dim=0, lru_width=0,
        window=min(base.window, args.seq_len) if base.window else 0,
        use_kernels=False)          # the kernels have no backward
    n_params = cfg.n_params()
    print(f"training {cfg.name}-reduced: {n_params/1e6:.1f}M params")

    hp = adamw.AdamWConfig(lr=args.lr, warmup_steps=30,
                           total_steps=args.steps, weight_decay=0.1)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.batch)
    with (tempfile.TemporaryDirectory() if args.ckpt_dir is None
          else contextlib.nullcontext(args.ckpt_dir)) as ckpt_dir:
        tc = TrainConfig(steps=args.steps, save_every=100, log_every=10,
                         ckpt_dir=ckpt_dir)
        trainer = Trainer(cfg, hp, tc, dc, args.device)
        result = trainer.run()
    print(f"done: final loss {result['final_loss']:.4f} "
          f"after {result['steps']} steps")
    return {"losses": [m["loss"] for m in trainer.metrics_log],
            "steps": [m["step"] for m in trainer.metrics_log],
            "model": result["model"], "opt": result["opt"]}


if __name__ == "__main__":
    main()
