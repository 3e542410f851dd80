"""G-GPU execution engine in PyTorch: the stages of the SIMT
cycle-approximate simulator (counterpart of ``repro.ggpu.engine``).

  * ``config``    — ``GGPUConfig`` / ``ScalarConfig``
  * ``frontend``  — fetch/decode (min-PC reconvergence), operand read,
    retire (writeback + PC advance)
  * ``alu``       — the PE integer datapath in plain PyTorch, the plain
    version of the CUDA kernel ``repro_torch.kernels.pe_simd``
  * ``memsys``    — ``SharedCache`` / ``BankedPerCUCache`` and the
    functional ``load_store``
  * ``scheduler`` — resident-wavefront selection and the lockstep-round
    cycle model
  * ``stepper``   — composition root: the round loop and the synchronous
    single/cohort/batch entry points
"""
from repro_torch.ggpu.engine.alu import branch_taken, exec_alu, select_alu
from repro_torch.ggpu.engine.config import GGPUConfig, ScalarConfig
from repro_torch.ggpu.engine.memsys import (MEMSYS, BankedPerCUCache,
                                            CacheResult, SharedCache,
                                            get_memsys)
from repro_torch.ggpu.engine.stepper import (KernelLaunchError, MachineState,
                                             run_kernel, run_kernel_batch,
                                             run_kernel_cohort)

__all__ = [
    "GGPUConfig", "ScalarConfig", "MachineState", "KernelLaunchError",
    "run_kernel", "run_kernel_batch", "run_kernel_cohort",
    "exec_alu", "select_alu", "branch_taken",
    "SharedCache", "BankedPerCUCache", "CacheResult", "MEMSYS", "get_memsys",
]
