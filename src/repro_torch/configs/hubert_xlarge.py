"""HuBERT-XLarge: encoder-only audio transformer (w2v2 arch). The conv
feature-extractor frontend is a stub: input_specs() provides precomputed
frame embeddings (d_frontend=512). vocab=504 is the target-unit inventory.
[arXiv:2106.07447; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab_size=504, causal=False, norm="layernorm", mlp="gelu",
    frontend="audio_frames", d_frontend=512,
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=64, causal=False, norm="layernorm", mlp="gelu",
    frontend="audio_frames", d_frontend=32,
)
