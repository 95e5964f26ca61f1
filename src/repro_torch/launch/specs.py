"""Abstract input specs for every (arch x shape) cell, as
``repro.launch.specs`` declares them: tensors on the ``meta`` device
(shape and dtype, no storage), which the dry run prices against the
sharding rules. For stub-frontend archs ([audio]/[vlm]) the modality
frontend's output (frame or patch embeddings) is an input."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import model as M


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    B, S = cell.global_batch, cell.seq_len
    batch = {"tokens": _sds((B, S), torch.int32), "labels": _sds((B, S), torch.int32)}
    if cfg.frontend == "vision_stub":
        batch["embeds"] = _sds((B, cfg.frontend_len, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = _sds((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return batch


def cache_specs(cfg: ModelConfig, B: int, S: int) -> Any:
    return M.init_cache(cfg, B, S, torch.bfloat16, device="meta")


def prefill_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    B, S = cell.global_batch, cell.seq_len
    prefix = cfg.frontend_len if cfg.frontend == "vision_stub" else 0
    out = {"tokens": _sds((B, S), torch.int32), "cache": cache_specs(cfg, B, S + prefix)}
    if cfg.frontend == "vision_stub":
        out["embeds"] = _sds((B, cfg.frontend_len, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = _sds((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return out


def decode_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    B, S = cell.global_batch, cell.seq_len
    prefix = cfg.frontend_len if cfg.frontend == "vision_stub" else 0
    return {"token": _sds((B,), torch.int32), "pos": _sds((), torch.int32),
            "cache": cache_specs(cfg, B, S + prefix)}


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """The dry run's entry: every model input of this cell."""
    if cell.kind == "train":
        return train_batch_specs(cfg, cell)
    if cell.kind == "prefill":
        return prefill_specs(cfg, cell)
    if cell.kind == "decode":
        return decode_specs(cfg, cell)
    raise ValueError(cell.kind)
