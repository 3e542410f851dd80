"""All decode time over all decode steps: the device spans of
``engine.decode_fn`` (between CUDA events, so a step's time includes the
device's waits for the host inside it), summed, over their count, ms."""


def read(run):
    spans = run.spans.ms("decode_step") if run.spans else []
    return sum(spans) / len(spans) if spans else None
