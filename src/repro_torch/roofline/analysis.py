"""Chip constants and model FLOPs (the part of the reference's
``repro.roofline.analysis`` that MeshPlanner reads).

The constants are one NVIDIA H100 SXM's, from NVIDIA's H100 Tensor Core
GPU data sheet (SXM column, dense rates without sparsity, at the 700 W
power limit); NVLink stands where the reference has the TPU's ICI.
"""
from __future__ import annotations

# --- NVIDIA H100 SXM (per card), data sheet ---------------------------------
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
ICI_BW = 900e9               # NVLink (4th gen) bytes/s per card
HBM_PER_CHIP = 80e9          # 80 GB of HBM3


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
