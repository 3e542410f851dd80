"""The G-GPU simulator in PyTorch: ISA, programs and the execution engine."""
