"""Qwen2-VL-72B backbone: M-RoPE, dynamic-resolution vision stub.
The ViT frontend is a stub: input_specs() provides precomputed patch
embeddings (d_frontend=1176 = 14x14x2x3 patchified pixels).
[arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152_064, mrope=True, mrope_sections=(16, 24, 24),
    frontend="vision_patches", d_frontend=1176, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, mrope=True, mrope_sections=(2, 3, 3),
    frontend="vision_patches", d_frontend=48,
)
