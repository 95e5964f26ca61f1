"""The per-layer kernels' public wrappers, as ``repro.kernels.ops``: the
``impl="pallas"`` path of the port.

Same signatures and int32 outputs as the reference. Each call is ONE kernel
launch on the card (``csrc/tnn_column.cu``, ``csrc/stdp_update.cu`` or
``csrc/wta.cu``): a single column is the C = 1 case of the layer kernels,
and the kernels mask ragged extents themselves, so nothing is padded. A CPU
tensor takes each kernel's plain PyTorch version.

The reference's tiling arguments (``block_b``, ``block_p``) and its
``interpret`` switch are accepted for signature parity and ignored: the
Hopper kernels choose their own launch geometry, and there is no interpret
mode on the card.

Usage, one layer's forward and learning (B, C, p, q = 32, 625, 32, 12)::

    z = ops.layer_forward_fused(x, w, theta=24, T=8)             # (B, C, q)
    u = torch.rand((C, 2, B, p, q), device=x.device)
    w2 = ops.layer_stdp_fused(w, x, z, u[:, 0], u[:, 1], T=8, w_max=7,
                              table=default_stabilize_table(7))   # (C, p, q)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.stdp_update import stdp_update_layer
from repro_torch.kernels.tnn_column import column_forward_layer
from repro_torch.kernels.wta import wta as _wta


def column_forward(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    theta: int,
    T: int = 8,
    wta: bool = False,
    block_b: int = 64,
    block_p: int = 256,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Fused column forward (+ optional WTA). x: (B, p), w: (p, q) -> (B, q) i32."""
    return column_forward_layer(x[:, None], w[None], theta=theta, T=T,
                                wta=wta)[:, 0]


def wta(z: torch.Tensor, *, T: int = 8, block_b: int = 128,
        interpret: Optional[bool] = None) -> torch.Tensor:
    """Post-forward WTA inhibition. z: (B, q) -> (B, q) i32."""
    return _wta(z, T=T)


def stdp_update(
    w: torch.Tensor,
    x: torch.Tensor,
    z: torch.Tensor,
    u_up: torch.Tensor,
    u_dn: torch.Tensor,
    *,
    T: int = 8,
    w_max: int = 7,
    table: tuple,
    mu_capture: float = 10 / 16,
    mu_backoff: float = 6 / 16,
    mu_search: float = 2 / 16,
    block_p: int = 128,
    block_b: int = 128,
    interpret: Optional[bool] = None,
    out: str = "weights",
) -> torch.Tensor:
    """Fused STDP wave update for one column: w (p, q), x (B, p), z (B, q),
    u_up/u_dn (B, p, q). Returns new (p, q) i32 weights, or the raw pre-clip
    (p, q) i32 net counters when ``out="net"``."""
    return stdp_update_layer(
        w[None], x[:, None], z[:, None], u_up[None], u_dn[None],
        T=T, w_max=w_max, table=table, mu_capture=mu_capture,
        mu_backoff=mu_backoff, mu_search=mu_search, out=out)[0]


def layer_forward_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    theta: int,
    T: int = 8,
    wta: bool = True,
    block_b: int = 64,
    block_p: int = 256,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Whole-layer fused forward+WTA: x (B, C, p), w (C, p, q) -> (B, C, q) i32,
    the layer's columns on one launch's grid."""
    return column_forward_layer(x, w, theta=theta, T=T, wta=wta)


def layer_stdp_fused(
    w: torch.Tensor,
    x: torch.Tensor,
    z: torch.Tensor,
    u_up: torch.Tensor,
    u_dn: torch.Tensor,
    *,
    T: int = 8,
    w_max: int = 7,
    table: tuple,
    mu_capture: float = 10 / 16,
    mu_backoff: float = 6 / 16,
    mu_search: float = 2 / 16,
    block_p: int = 128,
    block_b: int = 128,
    interpret: Optional[bool] = None,
    out: str = "weights",
) -> torch.Tensor:
    """Whole-layer fused STDP: w (C, p, q), x (B, C, p), z (B, C, q), u_up/u_dn
    (C, B, p, q) per-column uniforms. Returns (C, p, q) i32 weights, or the
    pre-clip batch-summed counters when ``out="net"``."""
    return stdp_update_layer(
        w, x, z, u_up, u_dn, T=T, w_max=w_max, table=table,
        mu_capture=mu_capture, mu_backoff=mu_backoff, mu_search=mu_search,
        out=out)
