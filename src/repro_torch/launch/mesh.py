"""The launch mesh (the port's ``repro.launch.mesh.make_launch_mesh``).

A ``LaunchMesh`` is the 1-D ``("data",)`` mesh the simulator's ``mesh=``
entry points shard their launch axis over (``repro_torch.ggpu.engine``,
``repro_torch.serve`` executors, schedulers and the fleet): a frozen,
hashable tuple of torch devices, equal by its devices, so it can key an
executor's envelope and the executor registry. Entry ``k`` runs shard
``k``'s machine on that device.

Entries may repeat: ``LaunchMesh(["cpu"] * 8)`` or ``LaunchMesh([card] *
8)`` is an 8-way split that runs on one device, its shards one after the
other on that device's current stream — how an 8-way split runs in the
tests and on a one-card machine (the reference forces 8 host devices for
the same purpose). ``make_launch_mesh`` takes the visible CUDA devices and
never falls back to the CPU.

The training meshes are ``DeviceMesh``es over the process group's world
with the reference's axis names: ``make_production_mesh`` (16 x 16
("data", "model"), or 2 x 16 x 16 ("pod", "data", "model")),
``make_host_mesh`` (1 x 1) and ``build_mesh``, the squarest (data, model)
factorisation of the world (the reference's ``launch/train.py``). Each
needs an initialised process group (``torch.distributed``): on one card
the world is one, and NCCL refuses two ranks on one device.

Mesh axes:
  pod   — across-pod data parallelism
  data  — data parallelism + the FSDP shard axis
  model — tensor/expert/sequence parallelism
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch import _device


@dataclass(frozen=True)
class LaunchMesh:
    """A 1-D ``("data",)`` mesh over ``devices`` (torch devices or their
    names; entries may repeat). ``devices`` holds the resolved devices as a
    tuple, as the reference reads ``np.ravel(mesh.devices)``."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(_device.resolve(d) for d in self.devices)
        if not devs:
            raise ValueError("a launch mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        """The mesh's extent: how many ways it splits the launch axis."""
        return len(self.devices)


def make_launch_mesh(n_devices=None) -> LaunchMesh:
    """A ``("data",)`` mesh over the first ``n_devices`` visible CUDA
    devices (all of them by default). With one card the mesh has extent 1
    and every sharded entry point takes the unsharded path. Raises when no
    card is visible or there are fewer than ``n_devices``."""
    _device.resolve(None)                  # raises without a card
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"need {n} devices, have {count}")
    devices: Tuple[torch.device, ...] = tuple(
        torch.device("cuda", i) for i in range(n))
    return LaunchMesh(devices)


def _device_type() -> str:
    """The mesh's device type: "cuda" where the process group's backend
    is NCCL, else "cpu"."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the world: 16 x 16 ("data", "model"), or
    2 x 16 x 16 ("pod", "data", "model"). Raises when the world is
    smaller."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for the production mesh, have {have}")
    return _mesh(shape, axes)


def make_host_mesh():
    """1-device mesh for smoke tests: same axis names, trivial sizes."""
    return _mesh((1, 1), ("data", "model"))


def build_mesh():
    """The squarest (data, model) factorisation of the world: model the
    largest divisor of the world size at most its square root."""
    import torch.distributed as dist
    n = dist.get_world_size()
    model = 1
    for m in range(int(n ** 0.5), 0, -1):
        if n % m == 0:
            model = m
            break
    return _mesh((n // model, model), ("data", "model"))
