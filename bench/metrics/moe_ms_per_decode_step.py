"""The device spans of the MoE FFN (``apply_moe``, every layer) inside
decode steps, summed, over the number of decode steps, in ms."""


def read(run):
    if run.spans is None:
        return None
    moe = run.spans.ms("moe", parent="decode_step")
    steps = run.spans.ms("decode_step")
    return sum(moe) / len(steps) if moe and steps else None
