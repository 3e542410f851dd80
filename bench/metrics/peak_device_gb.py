"""``torch.cuda.max_memory_allocated`` over set-up and the window, GB."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
