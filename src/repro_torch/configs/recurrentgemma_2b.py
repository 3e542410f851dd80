"""RecurrentGemma-2B (Griffin): RG-LRU + local attention, pattern 2:1.
head_dim=256 (10 heads x 256 = 2560), 1 KV head, local window 2048.
[arXiv:2402.19427; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256_000, window=2048, lru_width=2560,
    pattern_unit=("rglru", "rglru", "local"),
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
    vocab_size=256, window=16, lru_width=64,
    pattern_unit=("rglru", "rglru", "local"),
)
