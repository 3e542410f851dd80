"""The median device span of a wave's prefill (the module-level
``prefill`` that ``generate`` calls, between CUDA events), in ms."""
import statistics


def read(run):
    spans = run.spans.ms("prefill") if run.spans else []
    return statistics.median(spans) if spans else None
