"""Cycle-approximate SIMT simulator of the G-GPU, in PyTorch.

Re-export facade over ``repro_torch.ggpu.engine`` (the counterpart of
``repro.ggpu.machine``), limited to what the port has: the configs and the
synchronous entry points, each with ``device=`` (the card by default).
"""
from __future__ import annotations

from repro_torch.ggpu.engine import (GGPUConfig, KernelLaunchError,
                                     MachineState, ScalarConfig, run_kernel,
                                     run_kernel_batch, run_kernel_cohort)

__all__ = [
    "GGPUConfig", "ScalarConfig", "MachineState", "KernelLaunchError",
    "run_kernel", "run_kernel_batch", "run_kernel_cohort",
]
