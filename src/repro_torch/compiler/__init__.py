"""Kernel compiler front-end: tensor-expression DSL -> G-GPU programs (the
PyTorch port of ``repro.compiler``: host code in numpy, every simulation
on the port's engine, on the card unless a caller passes ``device``).

The workload-side generator that pairs with the hardware-side GPUPlanner
(the paper's "fully-automated" loop closed on both ends): a small traced
tensor DSL (``frontend``) over a per-item scalar expression IR (``ir``),
folded/strength-reduced/CSE'd (``opt``) and lowered to both the SIMT and
sequential-scalar ISA programs (``lower``) under a parameterized
``Schedule`` (coarsening, hoisting, branch idiom, const peeling). Every
compiled kernel is differentially verifiable against a NumPy oracle with
exact engine ALU semantics, ``suite`` re-derives all eight hand-written
benches from one-line DSL definitions, and ``autotune`` searches the
schedule space per kernel — or jointly with the hardware design space
(``codesign``) — costed in true cycles through the port's
``dse.Evaluator`` (DESIGN.md §Compiler, §Autotuner).
"""
from repro_torch.compiler.autotune import (DEFAULT_SPACE, SMOKE_SPACE,
                                           AutotuneResult, CodesignResult,
                                           ScheduleSpace, autotune,
                                           autotune_suite, codesign)
from repro_torch.compiler.frontend import (GraphTensor, Program,
                                           ScatterTensor, Tensor,
                                           compile_graph, compile_kernel, dsl)
from repro_torch.compiler.ir import CompileError
from repro_torch.compiler.lower import (DEFAULT_SCHEDULE, CompiledKernel,
                                        Schedule)
from repro_torch.compiler.suite import (compile_pair, def_args, dsl_benches,
                                        dsl_kernels, hand_benches,
                                        kernel_def)

__all__ = [
    "compile_kernel", "compile_graph", "Program", "GraphTensor",
    "dsl", "Tensor", "ScatterTensor",
    "CompiledKernel", "CompileError", "dsl_benches", "dsl_kernels",
    "hand_benches", "compile_pair", "kernel_def", "def_args",
    "Schedule", "DEFAULT_SCHEDULE", "ScheduleSpace", "DEFAULT_SPACE",
    "SMOKE_SPACE", "autotune", "autotune_suite", "AutotuneResult",
    "codesign", "CodesignResult",
]
