"""Dry run: trace one step of every (arch x shape) cell on the production
mesh, on the ``meta`` device, and record its roofline terms (the port's
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--multi-pod | --both-meshes] [--out experiments/dryrun]

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads XLA's cost and memory analyses. The port computes
nothing: it opens a stand-in world of 256 or 512 ranks (torch's fake
process group, in which a collective returns at once and moves nothing;
this process is rank 0), places the inputs on the production mesh by
the sharding rules as meta DTensors (``launch.specs``), runs the step
eagerly on them under ``set_rules`` and counts it with
``roofline.counter.StepCost``: dot FLOPs, HBM bytes, collectives and the
peak of live bytes, all per rank. A world is opened once per process,
so tests call the dry run in a subprocess.

The steps are the port's as they run today:
  * train: ``make_train_step(rules=)`` with AdamW, the remat policy and
    microbatches: the model bound to this rank's shards, each rank's rows
    of the batch, each layer unit's parameters gathered over the dp axes
    while it runs, tensor and sequence parallelism over "model" for
    attention, the MLPs, the MoE FFN, the embedding and the loss (the
    recurrent mixers whole on every rank), the gradients reduce-scattered
    to the shards, AdamW on the shards;
  * prefill (or HuBERT's encode) and decode: only serving keeps the old
    layout, the port having no sharded serving step (ROADMAP item 9d):
    the parameters placed by the rules and gathered whole
    (``gather_params``), computing on this rank's rows of the batch and
    cache, split by the dp axes (a cache's "model" split gathered).
    ``pos`` of decode is the cache's last slot.

The record keeps the reference's keys: ``arch``, ``shape``, ``mesh``,
``supported``, ``reason``, ``Roofline.asdict()``, ``lower_s`` (here the
trace's seconds), ``compile_s`` (0: nothing is compiled in eager
PyTorch), ``n_devices``, ``fits_hbm`` and ``total_dev_bytes`` (the peak
of live bytes: arguments + temporaries + outputs).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Optional, Union

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.specs import META, input_specs
from repro_torch.models import steps as S
from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec, \
    cell_supported
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline import analysis as RL
from repro_torch.roofline.counter import StepCost
from repro_torch.sharding import set_rules
from repro_torch.sharding.rules import _tree_map, make_rules, \
    param_shardings


def open_world(n: int) -> bool:
    """Open a stand-in world of ``n`` ranks, this process rank 0, unless
    a process group is open; one smaller than ``n`` raises. Returns
    whether it opened one."""
    if dist.is_initialized():
        if dist.get_world_size() < n:
            raise RuntimeError(f"a world of {dist.get_world_size()} is "
                               f"open; the dry run needs {n} ranks")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return True


def _own_cache(x):
    """This rank's rows of a cache leaf: its dp split kept, any other
    split gathered."""
    from torch.distributed.tensor import Replicate, Shard
    keep = tuple(pl if isinstance(pl, Shard) and pl.dim == 0
                 else Replicate() for pl in x.placements)
    return x.redistribute(x.device_mesh, keep).to_local()


def build_step(cfg: ModelConfig, shape: ShapeSpec, rules,
               microbatches: int = 1):
    """``step(model, *input_specs)``: one step of ``shape.kind`` on this
    rank, ``model`` the compute copy bound to the inputs' parameters:
    to every shard for train (``steps.bind_shards``), to the whole ones
    for serving (``steps.bind``)."""
    if shape.kind == "train":
        train = S.make_train_step(cfg, AdamWConfig(), microbatches, rules)

        def step(model, params, opt, batch):
            return train(model, opt, batch, params)
        return step
    serve = (S.make_encode_step(cfg) if cfg.is_encoder_only
             else S.make_prefill_step(cfg))

    def rows(batch):
        return {k: S._rows(k, v, 0, 1, rules) for k, v in batch.items()}

    if shape.kind == "prefill":
        def step(model, params, batch):
            S.gather_params(model, params)
            with torch.no_grad():
                return serve(model, rows(batch))
        return step
    decode = S.make_decode_step(cfg)

    def step(model, params, cache, token, pos):
        S.gather_params(model, params)
        local = _tree_map(_own_cache, cache)
        with torch.no_grad():
            return decode(model, local, S._rows("tokens", token, 0, 1, rules),
                          shape.seq_len - 1)
    return step


def run_cell(arch: Union[str, ModelConfig], shape: Union[str, ShapeSpec], *,
             multi_pod: bool = False, host: bool = False,
             remat: Optional[str] = None, microbatches: int = 1,
             fsdp: bool = True, seq_shard: bool = True,
             seq_attn_min_s: int = 16384, use_flash_kernel: bool = False,
             out_dir: Optional[Path] = None, verbose: bool = True) -> dict:
    """Trace one cell and return its record. ``arch`` is a name of
    ``ARCH_IDS`` or a config, ``shape`` a name of ``SHAPES`` or a
    ``ShapeSpec``. The mesh is the production one, 16 x 16 or (with
    ``multi_pod``) 2 x 16 x 16, or with ``host`` the one-device 1 x 1;
    it needs an open world of at least its size (``open_world``).
    ``use_flash_kernel`` sets ``use_kernels`` (MeshPlanner's knob): the
    kernels' wrappers take the meta device and note their work."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = cfg.replace(use_kernels=use_flash_kernel)
    if remat:
        cfg = cfg.replace(remat=remat)
    ok, reason = cell_supported(cfg, shape)
    label = "1x1" if host else "2x16x16" if multi_pod else "16x16"
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": label,
           "supported": ok, "reason": reason}
    if not ok:
        if verbose:
            print(f"[skip] {cfg.name} x {shape.name}: {reason}")
        return rec

    mesh = make_host_mesh() if host else make_production_mesh(
        multi_pod=multi_pod)
    rules = make_rules(mesh, fsdp=fsdp, seq_shard=seq_shard,
                       seq_attn_min_s=seq_attn_min_s)
    step = build_step(cfg, shape, rules, microbatches)
    t0 = time.time()
    with set_rules(rules):
        args = input_specs(cfg, shape, rules)
        model = LM(cfg, META)
        model.requires_grad_(shape.kind == "train")
        if shape.kind == "train":
            S.bind_shards(model, args[0], rules,
                          param_shardings(rules, cfg))
        else:
            S.bind(model, args[0])
        with StepCost() as cost:
            cost.hold(model, *args)
            out = step(model, *args)
        out_bytes = cost.out_bytes(out)
        del out
    t_lower = time.time() - t0

    n = int(mesh.size())
    roof = RL.analyze(cost, model_flops_total=RL.model_flops_estimate(
        cfg, shape), n_devices=n, out_bytes=out_bytes)
    total = roof.arg_bytes + roof.temp_bytes + roof.out_bytes
    rec.update(roof.asdict(), lower_s=round(t_lower, 1), compile_s=0.0,
               n_devices=n, fits_hbm=bool(total <= RL.HBM_PER_CHIP),
               total_dev_bytes=int(total))
    if verbose:
        print(f"[ok] {cfg.name} x {shape.name} ({label}): "
              f"compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms bound={roof.bound} "
              f"useful={roof.useful_ratio:.2f} "
              f"mem/dev={total/2**30:.2f}GiB fits={rec['fits_hbm']} "
              f"(trace {t_lower:.0f}s)")
        print(f"     flops={roof.flops:.3e} bytes={roof.bytes_hbm:.3e} "
              f"kernels={cost.kernels}")
        print(f"     collectives: {dict(roof.collectives.counts)}")
    if out_dir:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{cfg.name}_{shape.name}_{label}".replace("/", "-")
        (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> list:
    """Parse ``argv`` (the command line when None), open the stand-in
    world unless one is open (it stays open: one world per process), and
    dry-run the cells. Returns their records; exits 1 if any failed."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat")  # none | dots | full | group:<k>
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--seq-attn-min", type=int, default=16384)
    ap.add_argument("--flash-kernel", action="store_true",
                    help="MeshPlanner's use_flash_kernel: the kernels' "
                         "meta route (serving cells)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) required")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    open_world(512 if any(meshes) else 256)

    records, failures = [], 0
    for mp in meshes:
        for arch, shp in cells:
            try:
                records.append(run_cell(
                    arch, shp, multi_pod=mp, remat=args.remat,
                    microbatches=args.microbatches, fsdp=not args.no_fsdp,
                    seq_shard=not args.no_seq_shard,
                    seq_attn_min_s=args.seq_attn_min,
                    use_flash_kernel=args.flash_kernel, out_dir=out_dir))
            except Exception:
                failures += 1
                print(f"[FAIL] {arch} x {shp} multi_pod={mp}")
                traceback.print_exc()
    if failures:
        sys.exit(1)
    return records


if __name__ == "__main__":
    main()
