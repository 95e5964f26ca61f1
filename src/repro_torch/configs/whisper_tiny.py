"""whisper-tiny — encoder-decoder; conv/audio frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,  # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    act="gelu",
    layout_unit=("dec",),
    enc_seq=1500,  # 30 s of audio at 50 frames/s after the (stubbed) convs
    frontend="audio_stub",
    frontend_len=1500,
    tie_embeddings=True,
)
