"""The dry-run side of ``tests/test_torch_dryrun.py``: one process that
opens a stand-in world of 256 ranks (``dryrun.open_world``) and prints
one JSON object of what the test holds against hand counts and the JAX
package. Imports no JAX.

    PYTHONPATH=src python tests/_dryrun_world.py
"""
from __future__ import annotations

import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke
from repro_torch.convert import init_model
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import steps as S
from repro_torch.models.config import ShapeSpec
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline import analysis as RL
from repro_torch.roofline.counter import StepCost
from repro_torch.sharding import ctx, set_rules
from repro_torch.sharding.rules import distribute, input_shardings, make_rules

SEQ, ROWS = 64, 4                   # the one-device cells
PROD_ROWS = 32                      # the 16 x 16 cells: 2 rows a dp rank
HOST_CELLS = [("smollm-360m", "train", "none", 1),
              ("smollm-360m", "train", "full", 1),
              ("smollm-360m", "train", "none", 2),
              ("smollm-360m", "prefill", None, 1),
              ("smollm-360m", "decode", None, 1),
              ("mixtral-8x7b", "prefill", None, 1),
              ("mixtral-8x7b", "decode", None, 1)]
PROD_CELLS = [("smollm-360m", "train", "none"),
              ("mixtral-8x7b", "train", "none"),
              ("mixtral-8x7b", "train", "full"),
              ("smollm-360m", "decode", None)]


def collectives() -> dict:
    """An all-reduce of 1,000 f32 over "data", a DTensor gathered over
    "model", and one gathered over both."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_production_mesh()
    meta = torch.device("meta")
    one = DTensor.from_local(torch.empty(4, 8, device=meta), mesh,
                             (Replicate(), Shard(0)), run_check=False,
                             shape=(64, 8), stride=(8, 1))
    two = DTensor.from_local(torch.empty(2, 3, device=meta), mesh,
                             (Shard(0), Shard(1)), run_check=False,
                             shape=(32, 48), stride=(48, 1))
    out = {}
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(
                torch.empty(1000, device=meta), group=mesh.get_group("data"))),
            ("gather_model", one.full_tensor),
            ("gather_both", two.full_tensor)):
        with StepCost() as cost:
            fn()
        st = RL.parse_collectives(cost.calls)
        out[name] = {"calls": cost.calls, "ring_bytes": st.ring_bytes,
                     "counts": dict(st.counts)}
    return out


def host_cells() -> list:
    out = []
    for arch, kind, remat, mb in HOST_CELLS:
        rec = dryrun.run_cell(get_smoke(arch), ShapeSpec(kind, SEQ, ROWS,
                                                         kind),
                              host=True, remat=remat, microbatches=mb,
                              verbose=False)
        out.append({"arch": arch, "kind": kind, "remat": remat, "mb": mb,
                    "flops": rec["flops"]})
    return out


class Issued:
    """Records every collective the sharded train step issues, where it
    issues them: the plain collectives of ``sharding.ctx`` (kind, group
    size, bytes of the result per rank)."""
    WRAPPED = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
               "all_reduce": "all-reduce", "all_to_all": "all-to-all"}

    def __enter__(self):
        self.calls, self._orig = [], {n: getattr(ctx, n) for n in self.WRAPPED}
        for name, kind in self.WRAPPED.items():
            setattr(ctx, name, self._wrap(self._orig[name], kind))
        return self

    def _wrap(self, fn, kind):
        def run(x, *args, **kw):
            out = fn(x, *args, **kw)
            ax = next(a for a in args if isinstance(a, ctx.Axis))
            self.calls.append((kind, ax.n, out.numel() * out.element_size()))
            return out
        return run

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(ctx, name, fn)
        return False


def production_cells() -> list:
    out = []
    for arch, kind, remat in PROD_CELLS:
        with Issued() as issued:
            rec = dryrun.run_cell(get_smoke(arch), ShapeSpec(
                kind, SEQ, PROD_ROWS, kind), remat=remat, verbose=False)
        out.append({"arch": arch, "kind": kind, "remat": remat,
                    "record": rec, "issued": issued.calls})
    return out


def real_step() -> dict:
    """SmolLM's SMOKE train step for real on the CPU on the one-device
    mesh, counted, beside its dry run."""
    cfg = get_smoke("smollm-360m").replace(remat="none", use_kernels=False)
    shape = ShapeSpec("train", SEQ, ROWS, "train")
    dry = dryrun.run_cell(cfg, shape, host=True, verbose=False)
    rules = make_rules(make_host_mesh())
    torch.manual_seed(0)
    model = init_model(cfg, 0, "cpu")
    model.requires_grad_(True)
    params, opt = S.shard_state(model, rules, cfg)
    g = np.random.default_rng(0)
    batch = {k: torch.from_numpy(g.integers(0, cfg.vocab_size, (ROWS, SEQ))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    batch = {k: distribute(v, sh) for k, v, sh in zip(
        batch, batch.values(), input_shardings(rules, batch).values())}
    step = S.make_train_step(cfg, AdamWConfig(), 1, rules)
    with set_rules(rules), StepCost() as cost:
        cost.hold(model, params, opt, batch)
        step(model, opt, batch, params)
    return {"dry": {k: dry[k] for k in ("flops", "bytes_hbm", "arg_bytes",
                                        "total_dev_bytes")},
            "real": {"flops": cost.flops, "bytes_hbm": cost.bytes,
                     "arg_bytes": cost.arg_bytes,
                     "total_dev_bytes": cost.peak}}


def main() -> None:
    dryrun.open_world(256)
    print(json.dumps({"collectives": collectives(),
                      "host_cells": host_cells(),
                      "production_cells": production_cells(),
                      "real_step": real_step()}))


if __name__ == "__main__":
    main()
