"""internvl2-76b — VLM: InternViT frontend (STUB: input_specs provides patch
embeddings) + dense LM backbone. [arXiv:2404.16821; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    layout_unit=("dense",),
    frontend="vision_stub",
    frontend_len=256,  # image patch tokens prefixed to the text sequence
)
