"""Model configurations the port runs: the paper's TNN prototype
(``tnn_mnist``, a ``core.network.NetworkConfig``) and the ten LM-family
architectures of the reference's registry, ``get_config(name)`` /
``smoke_config(name)``.

Smoke variants keep the family's exact block structure but shrink every
width so a forward runs on a CPU in seconds; they equal the reference's
(``repro.configs.smoke_config``) field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (
    ModelConfig,
    SHAPE_GRID,
    ShapeCell,
    cell_applicable,
    cell_by_name,
)

from repro_torch.configs.llama3_2_3b import CONFIG as _llama
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.qwen1_5_4b import CONFIG as _qwen
from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.zamba2_7b import CONFIG as _zamba
from repro_torch.configs.internvl2_76b import CONFIG as _internvl

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _llama, _nemo, _qwen, _minicpm, _xlstm,
        _whisper, _mixtral, _grok, _zamba, _internvl,
    )
}

ARCHS: List[str] = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS} + tnn-mnist")
    return REGISTRY[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (1 unit repeat, tiny
    widths, few experts, tiny vocab, short stub frontends)."""
    cfg = get_config(name)
    heads = min(cfg.n_heads, 4)
    kv = min(cfg.n_kv_heads, heads)
    d_model = 64
    head_dim = 16
    updates = dict(
        n_layers=len(cfg.layout_unit) * 2 + len(cfg.layout_tail),
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=head_dim,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        layout_repeat=2,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state or cfg.family == "ssm" else cfg.ssm_head_dim,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=16 if cfg.enc_seq else 0,
        frontend_len=8 if cfg.frontend_len else 0,
        moe_groups=1,
    )
    if cfg.attention == "mla":
        updates.update(q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
                       qk_nope_dim=8, v_head_dim=16, head_dim=16)
    if cfg.family == "ssm":  # xlstm: head_dim = d_in/H
        updates.update(head_dim=(2 * d_model) // heads)
    return dataclasses.replace(cfg, **updates)


__all__ = [
    "ModelConfig", "ShapeCell", "SHAPE_GRID", "REGISTRY", "ARCHS",
    "get_config", "smoke_config", "cell_by_name", "cell_applicable",
]
