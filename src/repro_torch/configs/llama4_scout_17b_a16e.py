"""Llama-4-Scout-17B-16E: MoE 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202_048, n_experts=16, topk=1, rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, n_experts=4, topk=1, rope_theta=500_000.0,
)
