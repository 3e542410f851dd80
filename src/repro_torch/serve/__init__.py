"""Serving (the port's ``repro.serve``): the kernel-serving core for the
G-GPU simulator — requests, executors (with the stuck-device timeout),
the continuous-batching ``Scheduler`` (cohort/batch folding, pipelined
drain, quarantine, retry, checksum audits, device-resident dependency
patches), the multi-config ``Fleet`` (routing, health, eviction,
hedging), kernel graphs (a compiled ``Program`` served as a dependency
DAG, ``graphs``), the open-loop load generator and the legacy
``LaunchQueue`` — and the slot-batched LLM ``Engine``.

``repro_torch.serve.engine`` is the compatibility facade.
"""
from repro_torch.serve.executors import (DeviceTimeout, Executor,
                                         ExecutorStats, PendingChunk,
                                         get_executor, sim_key)
from repro_torch.serve.fleet import (Fleet, FleetDevice, FleetResilience,
                                     HedgePolicy, pinned_makespan)
from repro_torch.serve.graphs import (GraphTickets, extract_outputs,
                                      run_chains_host_staged, run_program,
                                      run_program_host_staged,
                                      run_programs_host_staged,
                                      submit_program, submit_programs)
from repro_torch.serve.llm import Engine, EngineConfig
from repro_torch.serve.loadgen import (LoadResult, bursty_arrivals,
                                       poisson_arrivals, replay)
from repro_torch.serve.policies import plan_fifo
from repro_torch.serve.request import (Dep, KernelLaunch, Request, Result,
                                       result_checksum)
from repro_torch.serve.routing import EarliestFinishRouter, RoundRobinRouter
from repro_torch.serve.scheduler import (AdmissionError, ChecksumError, Chunk,
                                         DeadlineExceeded, DependencyError,
                                         LaunchQueue, Quarantined,
                                         RetryPolicy, Scheduler, plan_chunks,
                                         plan_waves, wavefronts)

__all__ = [
    "AdmissionError", "ChecksumError", "Chunk", "DeadlineExceeded", "Dep",
    "DependencyError", "DeviceTimeout", "EarliestFinishRouter", "Engine",
    "EngineConfig", "Executor", "ExecutorStats", "Fleet", "FleetDevice",
    "FleetResilience", "GraphTickets", "HedgePolicy", "KernelLaunch",
    "LaunchQueue", "LoadResult", "PendingChunk", "Quarantined", "Request",
    "Result", "RetryPolicy", "RoundRobinRouter", "Scheduler",
    "bursty_arrivals", "extract_outputs", "get_executor", "pinned_makespan",
    "plan_chunks", "plan_fifo", "plan_waves", "poisson_arrivals", "replay",
    "result_checksum", "run_chains_host_staged", "run_program",
    "run_program_host_staged", "run_programs_host_staged", "sim_key",
    "submit_program", "submit_programs", "wavefronts",
]
