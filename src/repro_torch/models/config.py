"""Model and input-shape configuration (the port's copy of
``repro.models.config``).

Configs are frozen dataclasses with the reference's fields and defaults,
less the fields of paths the port does not run yet (MoE, M-RoPE, the
GELU MLP, LayerNorm, the modality frontends, the mLSTM chunk): the ported
config files copy over verbatim, and a config that needs one of those
paths cannot be built. ``use_pallas`` becomes ``use_kernels``, on by
default: prefill attention and the RG-LRU scan go through the port's
hand-written CUDA kernels (their plain versions for CPU tensors); False
runs the plain PyTorch path on whatever device the model lives on, and
is what training runs (the kernels have no backward).

``ShapeSpec``, ``SHAPES`` and ``cell_supported`` are the reference's
input shapes, which MeshPlanner plans for.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- attention options ---
    attn_bias: bool = False        # Qwen-style QKV bias
    window: int = 0                # 0 = full attention; >0 = sliding window
    causal: bool = True
    rope_theta: float = 10_000.0

    # --- layer pattern ---
    # Unit of block kinds repeated down the stack; remainder handled
    # explicitly. Kinds: attn | swa | local | rglru (mlstm | slstm: not
    # ported)
    pattern_unit: Tuple[str, ...] = ("attn",)

    # --- recurrent widths ---
    lru_width: int = 0             # RG-LRU width (0 -> d_model)
    conv_width: int = 4

    # --- MLP (SwiGLU) / norm (RMSNorm) ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- numerics ---
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # --- runtime knobs (overridable by the MeshPlanner) ---
    remat: str = "full"            # none | dots | full | group:k
    scan_layers: bool = True       # XLA's stacked-layer switch: no effect
    use_kernels: bool = True       # the hand-written CUDA kernels
    attn_q_chunk: int = 512        # blocked attention's q and kv tiles
    attn_kv_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is bounded (window, recurrence)."""
        kinds = set(self.pattern_unit)
        if kinds & {"mlstm", "slstm", "rglru"}:
            # fine unless some layer is *full* attention
            return "attn" not in kinds or self.window > 0
        return self.window > 0 or all(k in ("swa", "local") for k in kinds)

    @property
    def lru_d(self) -> int:
        return self.lru_width or self.d_model

    def pattern(self) -> Tuple[str, ...]:
        """Full per-layer kind list of length n_layers."""
        unit = self.pattern_unit
        reps = self.n_layers // len(unit)
        rem = self.n_layers % len(unit)
        return unit * reps + unit[:rem]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Analytic parameter count (matches the schema)."""
        from repro_torch.models.schema import count_params
        return count_params(self)

    def n_active_params(self) -> int:
        """Params touched per token: all of them (the port has no MoE)."""
        return self.n_params()


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell is runnable; reason if not."""
    if shape.kind == "decode" and cfg.is_encoder_only:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k decode needs "
                       "sub-quadratic attention")
    return True, ""
