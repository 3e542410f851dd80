"""Three-term roofline of one step per device (the port's
``repro.roofline.analysis``), against one NVIDIA H100:

    compute_s    = dot FLOPs per device / PEAK_FLOPS
    memory_s     = HBM bytes per device / HBM_BW
    collective_s = ring-model bytes per device / ICI_BW

The reference reads its FLOPs, bytes and collectives off compiled XLA
HLO; the port has none, and takes them from ``counter.StepCost``, which
counts an eager step op by op. ``Roofline`` keeps the reference's fields
and ``asdict()`` keys, so that both packages' dry-run records share one
schema. The ring model is the reference's: for a collective over a group
of n with a result of b bytes per device, all-reduce 2(n-1)/n * b,
all-gather and all-to-all (n-1)/n * b (b the full value), reduce-scatter
(n-1) * b (b the reduced shard), permute b.

The constants are one NVIDIA H100 SXM's, from NVIDIA's H100 Tensor Core
GPU data sheet (SXM column, dense rates without sparsity, at the 700 W
power limit); NVLink stands where the reference has the TPU's ICI.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Iterable, Tuple

# --- NVIDIA H100 SXM (per card), data sheet ---------------------------------
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
ICI_BW = 900e9               # NVLink (4th gen) bytes/s per card
HBM_PER_CHIP = 80e9          # 80 GB of HBM3


def ring_bytes(kind: str, n: int, b: float) -> float:
    """Per-device link bytes of one collective of ``kind`` over ``n``
    devices whose result is ``b`` bytes per device."""
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * b
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / n * b
    if kind == "reduce-scatter":
        return (n - 1.0) * b
    return float(b)                        # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    ring_bytes: float = 0.0            # per-device link bytes (ring model)
    raw_bytes: float = 0.0             # sum of result buffer bytes
    counts: Counter = dataclasses.field(default_factory=Counter)
    by_kind_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)


def parse_collectives(calls: Iterable[Tuple[str, int, int]]
                      ) -> CollectiveStats:
    """``CollectiveStats`` of a step's collectives, given as (kind, group
    size, result bytes per device) triples (``StepCost.calls``); a group
    of one moves nothing, as in the reference."""
    st = CollectiveStats()
    for kind, n, b in calls:
        if n <= 1:
            continue
        ring = ring_bytes(kind, n, b)
        st.ring_bytes += ring
        st.raw_bytes += b
        st.counts[kind] += 1
        st.by_kind_bytes[kind] = st.by_kind_bytes.get(kind, 0.0) + ring
    return st


@dataclasses.dataclass
class Roofline:
    flops: float                        # per device
    bytes_hbm: float                    # per device
    collectives: CollectiveStats
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0
    model_flops: float = 0.0            # 6*N*D style, per device
    useful_ratio: float = 0.0           # model_flops / counted flops
    raw_flops: float = 0.0              # the stock FLOP counter's total
    raw_bytes: float = 0.0              # bytes of every op, views included

    def asdict(self):
        d = dataclasses.asdict(self)
        d["collectives"] = {
            "ring_bytes": self.collectives.ring_bytes,
            "raw_bytes": self.collectives.raw_bytes,
            "counts": dict(self.collectives.counts),
            "by_kind_bytes": self.collectives.by_kind_bytes,
        }
        return d


def analyze(cost, *, model_flops_total: float = 0.0, n_devices: int = 1,
            out_bytes: int = 0) -> Roofline:
    """The roofline of a counted step: ``cost`` a ``counter.StepCost``
    after the step (its FLOPs, bytes, collectives, arguments and peak
    memory), ``out_bytes`` the bytes of the step's outputs
    (``cost.out_bytes(result)``). The peak splits into arguments,
    outputs and temporaries, as the reference splits XLA's memory
    analysis."""
    coll = parse_collectives(cost.calls)
    flops, bts = float(cost.flops), float(cost.bytes)
    compute_s = flops / PEAK_FLOPS
    memory_s = bts / HBM_BW
    coll_s = coll.ring_bytes / ICI_BW
    bound = max((("compute", compute_s), ("memory", memory_s),
                 ("collective", coll_s)), key=lambda kv: kv[1])[0]
    mf_dev = model_flops_total / max(n_devices, 1)
    return Roofline(
        flops=flops, bytes_hbm=bts, collectives=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bound=bound, arg_bytes=int(cost.arg_bytes), out_bytes=int(out_bytes),
        temp_bytes=int(cost.peak - cost.arg_bytes - out_bytes),
        model_flops=mf_dev,
        useful_ratio=(mf_dev / flops) if flops else 0.0,
        raw_flops=float(cost.raw_flops), raw_bytes=float(cost.raw_bytes))


def model_flops_estimate(cfg, shape) -> float:
    """Total step MODEL_FLOPS: 6*N_active*D for train, 2*N_active*B for
    decode (one token/seq), 2*N_active*D for prefill."""
    n_act = cfg.n_active_params()
    if shape.kind == "train":
        d_tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * d_tokens
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch          # decode: one token each
