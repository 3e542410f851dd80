"""Entry points (the port's ``repro.launch``): ``python -m
repro_torch.launch.train``."""
