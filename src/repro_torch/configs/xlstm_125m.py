"""xlstm-125m — sLSTM + mLSTM blocks (constant-state recurrence; runs the
long_500k cell). [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,  # xLSTM blocks carry their own up/down projections
    vocab_size=50304,
    head_dim=192,
    layout_unit=("mlstm", "mlstm", "slstm"),
    layout_repeat=4,
    ssm_expand=2,
    tie_embeddings=True,
)
