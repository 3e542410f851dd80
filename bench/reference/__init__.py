"""The benchmark's plain reference decoder (``decoder``): float32 PyTorch
with no kernel, cache or batching, written from the architectures'
published equations. It imports nothing of the program under test."""
