"""Hand-written Hopper kernels of the port, each beside its plain version.

  * ``pe_simd.pe_execute`` — the G-GPU PE execute stage (CUDA C++,
    ``csrc/pe_simd.cu``), replacing the Pallas kernel
    ``repro/kernels/pe_simd.py::pe_execute``;
  * ``flash_attention.flash_attention`` — blocked online-softmax attention
    (CUDA C++, ``csrc/flash_attention.cu``), replacing
    ``repro/kernels/flash_attention.py::flash_attention``; ``ops`` holds
    its (B, S, H, hd) head-fold wrapper;
  * ``rglru_scan.rglru_scan`` — the RG-LRU linear recurrence (CUDA C++,
    ``csrc/rglru_scan.cu``), replacing
    ``repro/kernels/rglru_scan.py::rglru_scan``.

The plain versions live in ``ref``. Kernels are built with ``nvcc`` at
first use (``_build``), never when a module is imported.
"""
