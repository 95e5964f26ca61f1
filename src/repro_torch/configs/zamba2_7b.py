"""zamba2-7b — hybrid: Mamba2 backbone + a SHARED attention block invoked
every 6th layer (weights stored once). Constant-state SSM decode means the
long_500k cell runs. [arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    layout_unit=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    layout_repeat=13,
    layout_tail=("mamba", "mamba", "mamba"),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
)
