"""PyTorch/CUDA port of the G-GPU cycle simulator, for one NVIDIA H100.

Mirrors the paths of the JAX package ``repro`` so each module's
counterpart is easy to find, and imports nothing of it: it keeps its own
copies of the ISA, the configuration and the benchmark programs. The PE
execute stage runs the hand-written CUDA kernel in
``repro_torch.kernels.csrc.pe_simd``; every other stage is plain PyTorch.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
