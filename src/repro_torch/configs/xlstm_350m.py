"""xLSTM-350M: sLSTM + mLSTM blocks, attention-free. d_ff=0: xLSTM blocks
carry their own up/down projections, no separate FFN. Block ratio choice
(3 mLSTM : 1 sLSTM) follows the xLSTM paper's mixed configs.
[arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50_304, mlp="none",
    pattern_unit=("mlstm", "mlstm", "mlstm", "slstm"),
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0,
    vocab_size=256, mlp="none",
    pattern_unit=("mlstm", "mlstm", "mlstm", "slstm"), mlstm_chunk=8,
)
