"""Mixtral-8x7B: MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32_000, n_experts=8, topk=2, window=4096,
    pattern_unit=("swa",), rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, n_experts=4, topk=2, window=16,
    pattern_unit=("swa",), rope_theta=1_000_000.0,
)
