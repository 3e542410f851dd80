"""The share of the window in which no operation ran on the device: 1 -
the union of the traced operations' intervals over the window, in %."""


def read(run):
    if run.device_trace is None:
        return None
    return 100.0 * (1.0 - run.device_trace.busy_s() / run.window_s)
