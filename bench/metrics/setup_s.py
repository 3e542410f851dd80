"""Seconds from the process's start to the window's: imports, the weights
made on the device, the engine, the warm-up wave, the kernels' build
where it is not cached yet, and in a traced run the profiler's start."""


def read(run):
    return run.setup_s
