"""Hand-written Hopper kernels of the port, each beside its plain version.

  * ``pe_simd.pe_execute`` — the G-GPU PE execute stage (CUDA C++,
    ``csrc/pe_simd.cu``), replacing the Pallas kernel
    ``repro/kernels/pe_simd.py::pe_execute``.

Kernels are built with ``nvcc`` at first use (``_build``), never when a
module is imported.
"""
