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

The training meshes (``make_production_mesh``, ``make_host_mesh``) are
not ported yet: they wait for sharded training (ROADMAP.md, item 9b).
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
