"""The 95th percentile (numpy's linear interpolation) over every request
of the window of the host time from its wave's submission to the return
of its tokens, in ms. A request waits for its whole wave."""
import numpy as np


def read(run):
    ms = [(w.returned - w.submitted) * 1e3 for w in run.waves
          for _ in w.prompts]
    return float(np.percentile(ms, 95))
