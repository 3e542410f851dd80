"""Cycle-approximate SIMT simulator of the G-GPU, in PyTorch.

Re-export facade over ``repro_torch.ggpu.engine`` (the counterpart of
``repro.ggpu.machine``): the configs, the entry points and their
``_async`` twins with ``LaunchHandle`` and the patch forms, each entry
point with ``device=`` (the card by default).
"""
from __future__ import annotations

from repro_torch.ggpu.engine import (BlockPatch, GGPUConfig,
                                     KernelLaunchError, LaunchHandle,
                                     MachineState, ScalarConfig,
                                     XorBlockPatch, run_kernel,
                                     run_kernel_async, run_kernel_batch,
                                     run_kernel_batch_async,
                                     run_kernel_cohort,
                                     run_kernel_cohort_async)

__all__ = [
    "GGPUConfig", "ScalarConfig", "MachineState", "KernelLaunchError",
    "run_kernel", "run_kernel_batch", "run_kernel_cohort",
    "LaunchHandle", "BlockPatch", "XorBlockPatch",
    "run_kernel_async", "run_kernel_batch_async", "run_kernel_cohort_async",
]
