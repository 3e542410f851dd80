"""The benchmark of the PyTorch and CUDA port (``repro_torch``): LM
serving through ``Engine.generate``. ``python3 bench/run.py --help``."""
