"""Compatibility facade over the ``repro_torch.serve`` package (the
counterpart of ``repro.serve.engine``): the names that module exports,
from the port's modules.

  * ``serve.request``   — ``Request``/``Result`` model; ``KernelLaunch``
    is the legacy alias.
  * ``serve.scheduler`` — the continuous-batching ``Scheduler`` and the
    legacy strict-mode ``LaunchQueue``.
  * ``serve.llm``       — the slot-batched LLM ``Engine``.
"""
from repro_torch.ggpu.engine import GGPUConfig, KernelLaunchError
from repro_torch.serve.llm import Engine, EngineConfig
from repro_torch.serve.request import KernelLaunch, Request, Result
from repro_torch.serve.scheduler import LaunchQueue, Scheduler

__all__ = [
    "Engine", "EngineConfig", "GGPUConfig", "KernelLaunch",
    "KernelLaunchError", "LaunchQueue", "Request", "Result", "Scheduler",
]
