"""Architecture configuration schema + the shape grid assigned to this paper.

The port's own copy of ``repro.configs.base`` (pure Python, field for field
the same): every assigned architecture is a ``ModelConfig``; the four
input-shape cells (train_4k / prefill_32k / decode_32k / long_500k) are
``ShapeCell``s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention flavour
    attention: str = "gqa"  # gqa | mla
    qkv_bias: bool = False
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 10_000.0

    # MLA (multi-head latent attention, MiniCPM3/DeepSeek style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM / hybrid / recurrent
    # layout: repeated unit of block kinds; total layers = len(unit)*repeat + len(tail)
    layout_unit: Tuple[str, ...] = ("dense",)
    layout_repeat: int = 0  # 0 -> n_layers (unit must be ("dense",) etc.)
    layout_tail: Tuple[str, ...] = ()
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4

    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq: int = 0  # encoder frame count (stub frontend length)

    # stub modality frontend (audio/vision): input_specs provides embeddings
    frontend: str = ""  # "" | audio_stub | vision_stub
    frontend_len: int = 0

    # misc
    scan_layers: bool = True  # the reference scans the stacked layers (False:
    #                           unrolled); the port always loops over them
    act: str = "swiglu"  # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"  # none | dots | full (activation checkpointing policy)

    # distribution hints (overridable per run)
    moe_groups: int = 0  # 0 -> one routing group per data shard
    moe_group_shape: Tuple[int, ...] = ()  # (batch_shards, seq_shards)

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.layout_repeat == 0:
            object.__setattr__(self, "layout_repeat", self.n_layers // max(len(self.layout_unit), 1))

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return self.layout_unit * self.layout_repeat + self.layout_tail

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve a 500k-token context? (SSM/hybrid/linear-attn
        or sliding-window attention only — DESIGN.md shape-grid skips.)"""
        kinds = set(self.layer_kinds)
        if kinds & {"mamba", "mlstm", "slstm"}:
            return True
        return self.sliding_window > 0

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for kind in self.layer_kinds:
            if kind in ("dense", "enc", "dec"):
                attn = d * H * hd + 2 * d * KV * hd + H * hd * d
                total += attn + 3 * d * f + 2 * d
                if kind == "dec":
                    total += attn + d  # cross attention
            elif kind == "moe":
                attn = d * H * hd + 2 * d * KV * hd + H * hd * d
                total += attn + self.n_experts * 3 * d * f + d * self.n_experts + 2 * d
            elif kind == "mla":
                r_q, r_kv = self.q_lora_rank, self.kv_lora_rank
                qk = self.qk_rope_dim + self.qk_nope_dim
                total += d * r_q + r_q * H * qk
                total += d * (r_kv + self.qk_rope_dim)
                total += r_kv * H * (self.qk_nope_dim + self.v_head_dim)
                total += H * self.v_head_dim * d
                total += 3 * d * f + 2 * d
            elif kind == "mamba":
                d_in = self.ssm_expand * d
                n = self.ssm_state
                heads = d_in // self.ssm_head_dim
                total += d * (2 * d_in + 2 * n + heads) + d_in * d + d
            elif kind in ("mlstm", "slstm"):
                # xLSTM blocks: pre-up-projection (x2), gates, down-projection
                d_in = self.ssm_expand * d
                if kind == "mlstm":
                    total += d * 2 * d_in + 3 * d_in * d_in // max(self.n_heads, 1) + d_in * d + d
                else:
                    total += 4 * d * d + 4 * d * (d // max(self.n_heads, 1)) + 3 * d * f // 1 + 2 * d
            elif kind == "shared_attn":
                pass  # weights counted once in the shared block
            else:
                raise ValueError(kind)
        if "shared_attn" in self.layer_kinds:
            attn = d * H * hd + 2 * d * KV * hd + H * hd * d
            total += attn + 2 * d
        if self.n_enc_layers:
            attn = d * H * hd + 2 * d * KV * hd + H * hd * d
            total += self.n_enc_layers * (attn + 2 * d * f + 2 * d)
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: experts_per_token of n_experts)."""
        if self.family != "moe" or not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_moe = self.layer_kinds.count("moe") * self.n_experts * 3 * d * f
        active = self.layer_kinds.count("moe") * self.experts_per_token * 3 * d * f
        return self.n_params() - dense_moe + active


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPE_GRID: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


def cell_by_name(name: str) -> ShapeCell:
    for c in SHAPE_GRID:
        if c.name == name:
            return c
    raise KeyError(name)


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Shape-grid applicability (skips documented in DESIGN.md §4)."""
    if cell.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full-attention arch cannot serve 524k context (sub-quadratic required)"
    return True, ""
