"""SmolLM-360M: llama-arch small, tied embeddings.
[hf:HuggingFaceTB/SmolLM-360M; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab_size=49_152, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-smoke", family="dense",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, d_ff=128,
    vocab_size=256, tie_embeddings=True,
)
