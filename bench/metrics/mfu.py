"""Model FLOPs of the window's requests' own tokens (``counts.
request_flops``: no pads, no capacity slack) over the window's seconds
times the bf16 peak (989 TFLOP/s), in %."""
from bench import counts


def read(run):
    flops = sum(counts.request_flops(run.arch, len(p), len(o) - len(p))
                for w in run.waves for p, o in zip(w.prompts, w.outputs))
    return 100.0 * flops / (run.window_s * counts.PEAK_BF16_FLOPS)
