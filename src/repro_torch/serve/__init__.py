"""Serving (the port's ``repro.serve``): the kernel-serving core for the
G-GPU simulator — requests, executors, the continuous-batching
``Scheduler`` (cohort/batch folding, pipelined drain, quarantine, retry,
checksum audits, device-resident dependency patches) and the legacy
``LaunchQueue`` — and the slot-batched LLM ``Engine``.

``repro_torch.serve.engine`` is the compatibility facade. Not ported yet:
``fleet``, ``routing``, ``loadgen`` and ``graphs`` (ROADMAP.md).
"""
from repro_torch.serve.executors import (DeviceTimeout, Executor,
                                         ExecutorStats, PendingChunk,
                                         get_executor, sim_key)
from repro_torch.serve.llm import Engine, EngineConfig
from repro_torch.serve.policies import plan_fifo
from repro_torch.serve.request import (Dep, KernelLaunch, Request, Result,
                                       result_checksum)
from repro_torch.serve.scheduler import (AdmissionError, ChecksumError, Chunk,
                                         DeadlineExceeded, DependencyError,
                                         LaunchQueue, Quarantined,
                                         RetryPolicy, Scheduler, plan_chunks,
                                         plan_waves, wavefronts)

__all__ = [
    "AdmissionError", "ChecksumError", "Chunk", "DeadlineExceeded", "Dep",
    "DependencyError", "DeviceTimeout", "Engine", "EngineConfig",
    "Executor", "ExecutorStats", "KernelLaunch", "LaunchQueue",
    "PendingChunk", "Quarantined", "Request", "Result", "RetryPolicy",
    "Scheduler", "get_executor", "plan_chunks", "plan_fifo", "plan_waves",
    "result_checksum", "sim_key", "wavefronts",
]
