"""Machine configuration for the G-GPU execution engine (PyTorch port).

The same frozen fields and defaults as ``repro.ggpu.engine.config``, so a
configuration converts field for field (``repro_torch.convert``):

  * ``memsys``   — the cache organization by name on the ``MEMSYS``
                   registry axis (``"shared"`` | ``"banked"`` |
                   ``"banked-iso"``, see
                   ``repro_torch.ggpu.engine.memsys``).
  * ``fuse``     — how many lockstep rounds the stepper enqueues between two
                   host-side termination checks. Result- and cycle-neutral:
                   rounds after every element halts are exact no-ops.
  * ``pipeline_depth`` — planner-inserted pipeline stages; each adds one
                   issue cycle per executing wavefront per round plus one
                   refill cycle when the wavefront takes a branch. Depth 0
                   is the pre-knob cost model.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GGPUConfig:
    n_cus: int = 1
    wavefront: int = 64
    pes_per_cu: int = 8
    cache_lines: int = 256   # 16 KiB data cache (FGPU default)
    line_words: int = 16
    miss_penalty: int = 24
    dram_line_cycles: int = 4
    max_wf_per_cu: int = 8
    ports: int = 4
    freq_mhz: float = 500.0
    max_steps: int = 2_000_000
    memsys: str = "shared"   # cache organization (MEMSYS registry axis)
    fuse: int = 4            # rounds between host-side termination checks
    pipeline_depth: int = 0  # planner-inserted stages: extra issue/branch CPI

    @property
    def issue_cycles(self) -> int:
        return max(1, self.wavefront // self.pes_per_cu)


@dataclass(frozen=True)
class ScalarConfig(GGPUConfig):
    """The RISC-V-class in-order scalar baseline: 1 lane, 1 PE, CPI~1,
    non-pipelined MUL/DIV (CV32E40P-style), single memory port."""
    n_cus: int = 1
    wavefront: int = 1
    pes_per_cu: int = 1
    ports: int = 1
    cache_lines: int = 256
    freq_mhz: float = 667.0
