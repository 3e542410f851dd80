"""Qwen1.5-0.5B: dense, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab_size=151_936, attn_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, attn_bias=True,
)
