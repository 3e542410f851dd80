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
  * ``stepper``   — composition root: the round loop, the single/cohort/
    batch entry points and their ``_async`` twins (``LaunchHandle``,
    patches), ``mesh=`` sharding of the launch axis (``launch_shards``,
    ``cohort_rows``) and the ``legacy=True`` reference stepper
"""
from repro_torch.ggpu.engine.alu import branch_taken, exec_alu, select_alu
from repro_torch.ggpu.engine.config import GGPUConfig, ScalarConfig
from repro_torch.ggpu.engine.memsys import (MEMSYS_REGISTRY,
                                            BankedPerCUCache, CacheResult,
                                            SharedCache, get_memsys)
from repro_torch.ggpu.engine.stepper import (BlockPatch, KernelLaunchError,
                                             LaunchHandle, MachineState,
                                             XorBlockPatch, cohort_rows,
                                             launch_shards, run_kernel,
                                             run_kernel_async,
                                             run_kernel_batch,
                                             run_kernel_batch_async,
                                             run_kernel_cohort,
                                             run_kernel_cohort_async)

__all__ = [
    "GGPUConfig", "ScalarConfig", "MachineState", "KernelLaunchError",
    "LaunchHandle", "BlockPatch", "XorBlockPatch", "cohort_rows",
    "launch_shards",
    "run_kernel", "run_kernel_batch", "run_kernel_cohort",
    "run_kernel_async", "run_kernel_batch_async", "run_kernel_cohort_async",
    "exec_alu", "select_alu", "branch_taken",
    "SharedCache", "BankedPerCUCache", "CacheResult", "MEMSYS_REGISTRY",
    "get_memsys",
]
