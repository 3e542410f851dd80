"""Rank processes for ``tests/test_torch_sharded_train.py`` and
``tests/test_torch_tp_*.py``: a world of gloo ranks on the CPU runs a
list of jobs, each on its own ``DeviceMesh``, and rank 0 saves what they
return. Imports no JAX.

A "steps" job may override config fields (``overrides``) and the rules'
(``rules_kw``), count its first step's dot FLOPs on each rank
(``count``), and run in float64 throughout (``f64``, its one-device
reference too): every float32 tensor the step makes, the model's f32
upcasts (``.float()``) included, is made float64 (``Float64``), so that
the comparison reads the arithmetic, not f32 rounding."""
from __future__ import annotations

import os
import time
import traceback
from contextlib import nullcontext

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke
from repro_torch.convert import init_model
from repro_torch.data import pipeline as pipe
from repro_torch.models import steps as S
from repro_torch.optim import adamw
from repro_torch.roofline.counter import StepCost
from repro_torch.sharding import set_rules
from repro_torch.sharding.rules import input_shardings, make_rules, \
    opt_state_shardings, param_shardings
from repro_torch.train import checkpoint
from repro_torch.train.trainer import Trainer, TrainConfig

LR = 1e-3
HP = adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
SEQ = 32


def cfg_of(arch, f64=False, **overrides):
    dt = "float64" if f64 else "float32"
    return get_smoke(arch).replace(compute_dtype=dt, param_dtype=dt,
                                   use_kernels=False, attn_q_chunk=8,
                                   attn_kv_chunk=16, **overrides)


class Float64:
    """Within the block every float32 tensor made is float64: the default
    dtype, ``.float()``, and a ``dtype=float32`` argument of the creation
    functions the model calls (patched in ``torch`` itself, so that a
    checkpoint's recompute in the backward makes the same)."""
    MAKERS = ("zeros", "full", "arange")

    def __enter__(self):
        def f64(fn):
            def make(*args, **kw):
                if kw.get("dtype") is torch.float32:
                    kw["dtype"] = torch.float64
                return fn(*args, **kw)
            return make
        self._saved = (torch.get_default_dtype(), torch.Tensor.float,
                       {n: getattr(torch, n) for n in self.MAKERS})
        torch.set_default_dtype(torch.float64)
        torch.Tensor.float = torch.Tensor.double
        for n, fn in self._saved[2].items():
            setattr(torch, n, f64(fn))
        return self

    def __exit__(self, *exc):
        dt, torch.Tensor.float, makers = self._saved
        torch.set_default_dtype(dt)
        for n, fn in makers.items():
            setattr(torch, n, fn)
        return False


def _precision(f64: bool):
    return Float64() if f64 else nullcontext()


def batch_of(cfg, rows: int, seed: int) -> dict:
    """A global batch: tokens and, for M-RoPE, (3, B, S) positions whose
    three streams differ."""
    g = np.random.default_rng(seed)
    out = {"tokens": g.integers(0, cfg.vocab_size,
                                (rows, SEQ + 1)).astype(np.int32)}
    if cfg.mrope:
        base = np.arange(SEQ + 1)[None, None, :] + g.integers(
            0, 5, (3, rows, 1))
        out["positions"] = (base // np.array([1, 2, 3])[:, None, None]
                            ).astype(np.int64)
    return out


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                         "model")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


class _Grads:
    """Records the whole gradients each step's global norm reads: the
    one-device step's (``adamw.global_norm``), and the sharded step's
    shards (``steps.global_norm``) gathered whole."""

    def __enter__(self):
        self.steps = []
        self._orig = adamw.global_norm, S.global_norm

        def rec(tensors):
            ts = list(tensors)
            self.steps.append([t.detach().clone() for t in ts])
            return self._orig[0](ts)

        def rec_shards(grads, params):
            from torch.distributed.tensor import DTensor
            self.steps.append([DTensor.from_local(
                g.detach(), p.device_mesh, p.placements, run_check=False,
                shape=p.shape, stride=p.stride()).full_tensor()
                for g, p in zip(grads, params)])
            return self._orig[1](grads, params)
        adamw.global_norm, S.global_norm = rec, rec_shards
        return self

    def __exit__(self, *exc):
        adamw.global_norm, S.global_norm = self._orig
        return False


def _state(params, opt) -> dict:
    """The state in full: params, moments and step as plain tensors."""
    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x
    names = sorted(params)
    return {"params": {n: full(params[n]).detach().clone() for n in names},
            "m": {n: full(opt.m[n]).clone() for n in names},
            "v": {n: full(opt.v[n]).clone() for n in names},
            "step": int(full(opt.step))}


def steps_job(arch, mesh, microbatches=1, rows=4, n_steps=3, overrides=None,
              rules_kw=None, count=False, f64=False):
    """``n_steps`` sharded steps on ``mesh`` (the same weights and global
    batches as ``one_device_job``)."""
    cfg = cfg_of(arch, f64, **(overrides or {}))
    rules = make_rules(_mesh(mesh), **(rules_kw or {}))
    metrics, flops = [], None
    with _precision(f64):
        model = init_model(cfg, 0, "cpu")
        model.requires_grad_(True)
        params, opt = S.shard_state(model, rules, cfg)
        step = S.make_train_step(cfg, HP, microbatches, rules)
        with _Grads() as rec, set_rules(rules):
            for i, b in enumerate(_batches(cfg, rows, n_steps)):
                tb = pipe.device_put_batch(b, input_shardings(rules, b))
                with StepCost() if count and i == 0 else nullcontext() as c:
                    out = step(model, opt, tb, params)
                flops = c.flops if c is not None else flops
                metrics.append({k: float(v) for k, v in out.items()})
    numel = {n: (params[n].to_local().numel(), params[n].numel(),
                 rules.axes_size(_axes(ps.spec)))
             for n, ps in param_shardings(rules, cfg).items()}
    numel.update({f"m/{n}": (opt.m[n].to_local().numel(), opt.m[n].numel(),
                             rules.axes_size(_axes(ps.spec)))
                  for n, ps in opt_state_shardings(rules, cfg).m.items()})
    return {"metrics": metrics, "grads": rec.steps, "flops": flops,
            "state": _state(params, opt), "numel": numel,
            "blocks": _blocks_at_offsets(params, rules, cfg)}


def _blocks_at_offsets(params, rules, cfg) -> bool:
    """Whether every rank's shard of every parameter is the block of the
    whole at its spec's offset for this rank (``local_offset``) and of
    its shape (``local_shape``)."""
    mesh = rules.mesh
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    ok = True
    for n, sh in param_shardings(rules, cfg).items():
        full = params[n].full_tensor()
        block = full
        for d, (at, size) in enumerate(zip(
                rules.local_offset(full.shape, sh.spec, coord),
                rules.local_shape(full.shape, sh.spec))):
            block = block.narrow(d, at, size)
        ok = ok and torch.equal(block, params[n].to_local())
    flag = torch.tensor(int(ok))
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag)


def one_device_job(arch, mesh=None, microbatches=1, rows=4, n_steps=3,
                   overrides=None, rules_kw=None, count=False, f64=False):
    """The one-device steps ``steps_job`` is held against (no
    collectives: each rank runs its share after the sharded jobs); with
    ``count``, its first step's dot FLOPs, which are the (1, 1) mesh's
    (a mesh of one rank computes the one-device step)."""
    cfg = cfg_of(arch, f64, **(overrides or {}))
    metrics, flops = [], None
    with _precision(f64):
        ref = init_model(cfg, 0, "cpu")
        ref.requires_grad_(True)
        ref_opt = adamw.init(dict(ref.named_parameters()))
        ref_step = S.make_train_step(cfg, HP, microbatches)
        with _Grads() as rec:
            for i, b in enumerate(_batches(cfg, rows, n_steps)):
                with StepCost() if count and i == 0 else nullcontext() as c:
                    out = ref_step(ref, ref_opt, pipe.to_device(b, "cpu"))
                flops = c.flops if c is not None else flops
                metrics.append({k: float(v) for k, v in out.items()})
    return {"metrics": metrics, "grads": rec.steps, "flops": flops,
            "state": _state(dict(ref.named_parameters()), ref_opt)}


def _batches(cfg, rows, n_steps):
    return [batch_of(cfg, rows, 100 + i) for i in range(n_steps)]


def _axes(spec):
    out = []
    for entry in spec:
        if entry is not None:
            out += [entry] if isinstance(entry, str) else list(entry)
    return out


def trainer_job(arch, mesh, ckpt_dir, n_steps=4):
    """The sharded Trainer (``tests/test_torch_trainer.py``'s settings
    for the JAX Trainer: 4 steps of 4 x 32 tokens in 2 microbatches, a
    save every 2); returns its losses and final state."""
    t = _trainer(arch, ckpt_dir, n_steps, make_rules(_mesh(mesh)))
    res = t.run()
    return {"losses": [m["loss"] for m in t.metrics_log],
            "state": _state(res["params"], res["opt"])}


def _wait_for(ckpt_dir, step, wait_s):
    deadline = time.monotonic() + wait_s
    while (checkpoint.latest_step(ckpt_dir) or 0) < step \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    dist.barrier()


def _trainer(arch, ckpt_dir, n_steps, rules=None):
    cfg = get_smoke(arch).replace(use_kernels=False, compute_dtype="float32")
    tc = TrainConfig(steps=n_steps, save_every=2, microbatches=2, seed=3,
                     ckpt_dir=ckpt_dir)
    hp = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    dc = pipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         global_batch=4)
    return Trainer(cfg, hp, tc, dc, "cpu" if rules is None else None,
                   rules=rules)


def resume_job(arch, mesh, ckpt_dir, step, out_dir, n_steps=6,
               wait_s=240.0):
    """The elastic restart: the Trainer on ``mesh`` resumes from a copy
    of the checkpoint of ``step`` (saved on another mesh) to ``n_steps``
    in one run ("sharded"); a second one from another copy stops a step
    short and resumes from its own checkpoint ("interrupted"); on rank 0
    the one-device Trainer resumes from a third copy. Returns the final
    states."""
    import shutil
    _wait_for(ckpt_dir, step, wait_s)
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    subs = ("sharded", "interrupted", "one_device")
    if dist.get_rank() == 0:
        for sub in subs:
            shutil.copytree(src, os.path.join(out_dir, sub,
                                              f"step_{step:08d}"))
    dist.barrier()
    out = {}
    for sub, stops in (("sharded", (n_steps,)),
                       ("interrupted", (n_steps - 1, n_steps))):
        for n in stops:
            res = _trainer(arch, os.path.join(out_dir, sub), n,
                           make_rules(_mesh(mesh))).run()
        out[sub] = _state(res["params"], res["opt"])
    if dist.get_rank() == 0:
        res = _trainer(arch, os.path.join(out_dir, "one_device"),
                       n_steps).run()
        out["one_device"] = _state(res["params"], res["opt"])
    return out


def restore_job(arch, mesh, ckpt_dir, step, wait_s=240.0):
    """The checkpoint restored onto ``mesh`` (waiting up to ``wait_s``
    for another world to write it): its state in full, and whether every
    rank's blocks are its parts of the full arrays."""
    _wait_for(ckpt_dir, step, wait_s)
    cfg = cfg_of(arch)
    rules = make_rules(_mesh(mesh))
    params, opt, _ = checkpoint.restore(
        ckpt_dir, step, "cpu", param_shardings(rules, cfg),
        opt_state_shardings(rules, cfg))
    full, _, _ = checkpoint.restore(ckpt_dir, step, "cpu")
    from repro_torch.sharding.rules import local_part
    blocks = all(torch.equal(x.to_local(), local_part(
        full[n], x.device_mesh, x.placements)) for n, x in params.items())
    ok = torch.tensor(int(blocks))
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    opt = adamw.AdamWState(opt["m"], opt["v"], opt["step"])
    return {"blocks_are_parts": bool(ok), "state": _state(params, opt)}


JOBS = {"steps": steps_job, "trainer": trainer_job, "restore": restore_job,
        "resume": resume_job}


def rank_main(rank: int, world: int, init_file: str, out_dir: str,
              jobs: list) -> None:
    """Run ``jobs`` [(name, kind, kwargs)] in order on a gloo world,
    then this rank's share of the one-device runs the "steps" jobs are
    held against (each rank every world-th, no collectives). Rank 0
    saves the jobs' results, every rank its one-device runs, to
    ``out_dir/rank<k>.pt``. A failure is written to ``out_dir/rank<k>.err``
    and ends the process with 1."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        results = {name: JOBS[kind](**kw) for name, kind, kw in jobs}
        dist.barrier()
        refs = [(name, kw) for name, kind, kw in jobs if kind == "steps"]
        mine = {name: one_device_job(**kw)
                for i, (name, kw) in enumerate(refs) if i % world == rank}
        torch.save({"jobs": results if rank == 0 else {}, "one_device": mine},
                   os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def start(world: int, jobs: list, tmp):
    """Start ``world`` spawned ranks running ``jobs``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    os.makedirs(tmp, exist_ok=True)
    procs = [ctx.Process(target=rank_main, args=(
        r, world, os.path.join(tmp, "init"), str(tmp), jobs))
        for r in range(world)]
    for p in procs:
        p.start()
    return procs, jobs, tmp


def collect(started, timeout: float = 300) -> dict:
    """Wait for ranks ``start`` began; returns rank 0's results, each
    "steps" job's as {"sharded", "one_device"}, or raises with the ranks'
    tracebacks."""
    procs, jobs, tmp = started
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
            if f.endswith(".err")]
    codes = [p.exitcode for p in procs]
    if errs or any(codes):
        raise RuntimeError(f"ranks exited {codes}:\n" + "\n".join(errs))
    saved = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(len(procs))]
    out = saved[0]["jobs"]
    for name, kind, _ in jobs:
        if kind == "steps":
            ref = next(s["one_device"][name] for s in saved
                       if name in s["one_device"])
            out[name] = {"sharded": out[name], "one_device": ref}
    return out
