"""Mixture-of-Experts FFN (Mixtral / Grok-1: 8 experts, top-2 routing), as
``repro.models.moe`` computes it.

GShard-style local groups: tokens are split into routing groups and each
group routes independently with a local capacity
``int((tokens_per_group * top_k / E) * capacity_factor) + 1``. Dispatch is
scatter-based (positions by a masked cumsum); tokens over capacity fall
through with a zero expert contribution (the residual carries them): they
are scattered to and gathered from ``(expert 0, slot cap - 1)`` with their
contribution and gate set to 0.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


def moe_spec(cfg) -> Dict[str, ParamSpec]:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, E), ("embed", None)),
        "wi": ParamSpec((E, d, f), ("expert", "embed", "mlp")),
        "wg": ParamSpec((E, d, f), ("expert", "embed", "mlp")),
        "wo": ParamSpec((E, f, d), ("expert", "mlp", "embed")),
    }


def top_k(logits: torch.Tensor, k: int):
    """The ``k`` largest values along the last axis and their indices, the
    lower index first among equal values (``lax.top_k``'s order; a stable
    descending sort keeps it, ``torch.topk`` does not promise it)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x: torch.Tensor, p: Dict, cfg, n_groups: int = 0) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). top-k routing with local groups tiling the
    (batch, seq) grid as ``moe_group_shape = (batch_shards, seq_shards)``
    (else ``(moe_groups or 1, 1)``); ``n_groups`` overrides it (decode: 1)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    dt = x.dtype
    dev = x.device
    tokens = B * S
    if n_groups:
        gb, gs = n_groups, 1
    else:
        gb, gs = getattr(cfg, "moe_group_shape", ()) or (cfg.moe_groups or 1, 1)
    while B % gb:
        gb //= 2
    while S % gs:
        gs //= 2
    G = gb * gs
    g_tokens = tokens // G
    cap = int((g_tokens * k / E) * cfg.moe_capacity_factor) + 1

    xg = (x.reshape(gb, B // gb, gs, S // gs, d)
          .permute(0, 2, 1, 3, 4)
          .reshape(G, g_tokens, d))
    logits = torch.matmul(xg, p["router"].to(dt)).float()
    gate, idx = top_k(logits, k)  # (G, T, k)
    gate = torch.softmax(gate, dim=-1).to(dt)

    # position of each (token, choice) within its expert's capacity buffer
    onehot = F.one_hot(idx, E)  # (G, T, k, E)
    flat = onehot.reshape(G, g_tokens * k, E)
    pos = torch.cumsum(flat, dim=1) - 1  # (G, T*k, E)
    pos = (pos * flat).sum(-1).reshape(G, g_tokens, k)  # (G, T, k)
    keep = pos < cap
    gate = gate * keep.to(dt)

    e_idx = torch.where(keep, idx, 0)
    c_idx = torch.where(keep, pos, cap - 1)
    contrib = torch.where(keep[..., None], xg[:, :, None, :], 0).to(dt)  # (G, T, k, d)
    g_idx = torch.arange(G, device=dev)[:, None, None].expand(G, g_tokens, k)
    buf = torch.zeros((G, E, cap, d), dtype=dt, device=dev)
    buf.index_put_((g_idx, e_idx, c_idx), contrib, accumulate=True)

    h = torch.einsum("gecd,edf->gecf", buf, p["wi"].to(dt))
    g_ = torch.einsum("gecd,edf->gecf", buf, p["wg"].to(dt))
    h = F.silu(g_) * h
    y = torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))

    out = y[g_idx, e_idx, c_idx] * gate[..., None]  # (G, T, k, d)
    return (out.sum(dim=2)
            .reshape(gb, gs, B // gb, S // gs, d)
            .permute(0, 2, 1, 3, 4)
            .reshape(B, S, d))
