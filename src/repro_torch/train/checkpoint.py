"""Atomic checkpoints (the port's ``repro.train.checkpoint``).

Layout: ``<dir>/step_<N>/{manifest.json, arrays.npz}``, N zero-padded to
8 digits. ``save`` takes nested dicts (and NamedTuples such as
``AdamWState``) of tensors and stores each leaf under its '/'-joined path
(``params/layers.0.mixer.wq.w``, ``opt/m/...``, ``opt/step``), copied to
the host. A bf16 tensor has no numpy dtype: its bits are stored as int16,
and the manifest names every leaf's dtype. ``restore`` rebuilds the trees
on an explicit device, the card unless the caller asks for another.

Sharded state (``torch.distributed.tensor.DTensor`` leaves) is saved in
full: every rank takes part in gathering each such leaf, rank 0 writes
the same files as an unsharded save, and a barrier follows. ``restore``
with ``shardings`` places the full arrays onto the CURRENT mesh: a
checkpoint saved under one mesh restores bit for bit under any other, or
on one device (the reference's elastic restart).

Atomicity: writes go to ``step_<N>.tmp`` then ``os.replace``: a job killed
mid-save never corrupts the latest checkpoint (``latest_step`` picks the
newest complete manifest and never a ``.tmp``).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import _device
from repro_torch.sharding.rules import NamedSharding, distribute, \
    mesh_device

# dtypes stored as the bits of an integer of their width
_AS_BITS = {torch.bfloat16: torch.int16}


def _flatten(tree, prefix: str = "") -> dict:
    if hasattr(tree, "_asdict") and not isinstance(tree, NamedSharding):
        tree = tree._asdict()
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for k, v in tree.items():
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in _AS_BITS:
        t = t.view(_AS_BITS[t.dtype])
    return t.cpu().numpy()


def save(ckpt_dir, step: int, params, opt_state=None,
         extra: Optional[dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    tree = {"params": params}
    if opt_state is not None:
        tree["opt"] = opt_state
    flat = _flatten(tree)
    sharded = any(isinstance(v, DTensor) for v in flat.values())
    writer = not sharded or dist.get_rank() == 0
    arrays = {}
    for k, v in flat.items():
        if isinstance(v, DTensor):          # every rank takes part
            v = v.full_tensor()
        if writer:
            arrays[k] = _to_numpy(v)
    if writer:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {"step": step, "keys": sorted(flat),
                    "dtypes": {k: str(v.dtype).removeprefix("torch.")
                               for k, v in flat.items()},
                    "time": time.time(), **(extra or {})}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    if sharded:
        dist.barrier()
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for d in ckpt_dir.iterdir():
        if d.is_dir() and d.name.startswith("step_") \
                and not d.name.endswith(".tmp") \
                and (d / "manifest.json").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, device=None, shardings=None,
            opt_shardings=None):
    """Returns (params, opt, manifest): the saved trees as tensors on
    ``device`` (the card by default), ``opt`` None if none was saved.
    With ``shardings`` ({parameter name: NamedSharding},
    ``sharding.rules.param_shardings``) the parameters, and with
    ``opt_shardings`` (``opt_state_shardings``) AdamW's state, are
    DTensors placed on the current mesh, each rank keeping its block."""
    device = _device.resolve(device)
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    placed = _flatten({"params": shardings or {},
                       "opt": opt_shardings or {}})
    flat = {}
    with np.load(d / "arrays.npz") as data:
        for key in manifest["keys"]:
            t = torch.from_numpy(data[key])
            dtype = getattr(torch, manifest["dtypes"][key])
            if dtype in _AS_BITS:
                t = t.view(dtype)
            sh = placed.get(key)
            flat[key] = (t.to(device) if sh is None else
                         distribute(t.to(mesh_device(sh.mesh)), sh))
    tree = _unflatten(flat)
    return tree["params"], tree.get("opt"), manifest
