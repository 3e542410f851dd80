"""Qwen1.5-4B: dense, QKV bias. [hf:Qwen/Qwen1.5-4B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab_size=151_936, attn_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, attn_bias=True, rope_theta=1_000_000.0,
)
