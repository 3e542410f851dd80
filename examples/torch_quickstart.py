"""Quickstart through the PyTorch port (``repro_torch``) on one NVIDIA
card: build a small model, train a few steps, generate text.

    PYTHONPATH=src python examples/torch_quickstart.py --ckpt-dir <dir>
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \
        --ckpt-dir <dir>

Training runs plain PyTorch (the kernels have no backward); generation
runs the prefill's attention through the ``flash_attention`` kernel on
the card (``--device cpu``: its plain version). The Trainer resumes from
the newest checkpoint in ``--ckpt-dir``: give each run a directory of
its own (the default is a fresh temporary one).
"""
import argparse
import contextlib
import tempfile

from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.serve import Engine, EngineConfig
from repro_torch.train.trainer import Trainer, TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh "
                         "temporary one, removed at the end)")
    ap.add_argument("--device", default=None,
                    help="where it runs (default: the card; 'cpu' for the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_smoke("smollm-360m")
    print(f"arch: {cfg.name}  layers={cfg.n_layers} d_model={cfg.d_model}")

    hp = adamw.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=60)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    with (tempfile.TemporaryDirectory() if args.ckpt_dir is None
          else contextlib.nullcontext(args.ckpt_dir)) as ckpt_dir:
        tc = TrainConfig(steps=40, save_every=20, log_every=10,
                         ckpt_dir=ckpt_dir)
        # the kernels have no backward: training takes the plain attention
        trainer = Trainer(cfg.replace(use_kernels=False), hp, tc, dc,
                          args.device)
        result = trainer.run()
    print(f"final loss: {result['final_loss']:.4f}")

    engine = Engine(cfg, result["model"], EngineConfig(slots=2))
    outs = engine.generate([[1, 2, 3], [7, 8]], max_new=8)
    print("generated:", outs)
    return {"losses": [m["loss"] for m in trainer.metrics_log],
            "generated": outs, "vocab_size": cfg.vocab_size}


if __name__ == "__main__":
    main()
