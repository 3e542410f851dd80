"""Carry state from the JAX package's objects into the port's.

The G-GPU simulator has no weights: its state is the machine
configuration, the ISA programs and the memory images. These helpers take
them as plain data (a config's ``dataclasses.asdict``, a bench's numpy
arrays), so the two packages run the same machines on the same data
without the port importing the JAX package.
"""
from __future__ import annotations

import numpy as np

from repro_torch.ggpu import programs
from repro_torch.ggpu.engine.config import GGPUConfig, ScalarConfig


def config_from_reference(fields: dict, scalar: bool = False) -> GGPUConfig:
    """The port's ``GGPUConfig`` (``ScalarConfig`` when ``scalar``) with
    the fields of a reference config, e.g. ``dataclasses.asdict(cfg)``.
    Raises ``TypeError`` on a field the port does not know."""
    return (ScalarConfig if scalar else GGPUConfig)(**fields)


def bench_from_arrays(name: str, gpu_prog, gpu_mem, gpu_items: int,
                      gpu_out: slice, scalar_prog, scalar_mem,
                      scalar_out: slice, gpu_n: int, scalar_n: int,
                      **_ignored) -> programs.Bench:
    """A port ``Bench`` from a reference bench's programs, memory images
    and output slices (pass ``vars(bench)``; its ``ref`` is not taken: the
    port's own reference for ``name`` is used)."""
    ref = programs.build(name, *programs.SMOKE_SIZES[name]).ref
    return programs.Bench(
        name, np.asarray(gpu_prog, np.int32).copy(),
        np.asarray(gpu_mem, np.int32).copy(), int(gpu_items), gpu_out,
        np.asarray(scalar_prog, np.int32).copy(),
        np.asarray(scalar_mem, np.int32).copy(), scalar_out, ref,
        int(gpu_n), int(scalar_n))
