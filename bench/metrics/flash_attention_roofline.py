"""Sum of the least times of the window's ``flash_attention`` calls
(``counts.flash_bound_s`` of each call's shapes: visible-pair FLOPs at
989 TFLOP/s or q, k, v and the output at 3.35 TB/s, the larger) over the
device time of the kernel (its two routes' operations in the trace),
in %."""
from bench import counts

KERNELS = ("flash_mma_kernel", "flash_simt_kernel")


def read(run):
    if run.spans is None or run.device_trace is None:
        return None
    bound = 0.0
    for c in run.spans.calls.get("flash_attention", []):
        b, sq, h, hd = c["q"]
        _, skv, hkv, _ = c["k"]
        bound += counts.flash_bound_s(b * h, b * hkv, sq, skv, hd,
                                      c["causal"], c["window"], c["itemsize"])
    spent = sum(e - s for name, s, e in run.device_trace.ops
                if any(k in name for k in KERNELS)) / 1e9
    return 100.0 * bound / spent if bound and spent else None
