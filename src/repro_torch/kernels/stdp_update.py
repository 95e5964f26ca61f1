"""Plain PyTorch version of the STDP counter body the reference's kernels
share (``repro.kernels.stdp_update.stdp_net_tile``). The Hopper wave
kernel's learning epilogue computes the same counters per synapse; the
per-layer STDP kernel that would call this is not ported yet."""
from __future__ import annotations

from typing import Sequence

import torch


def stdp_net_tile(
    w: torch.Tensor, x: torch.Tensor, z: torch.Tensor, uu: torch.Tensor,
    ud: torch.Tensor,
    *,
    T: int,
    w_max: int,
    table: Sequence[float],
    mu_capture: float,
    mu_backoff: float,
    mu_search: float,
) -> torch.Tensor:
    """One batch tile's pre-clip inc - dec counters.

    w (Pt, q); x (Bt, Pt); z (Bt, q); uu/ud (Bt, Pt, q) float32 ->
    (Pt, q) int32. The stabilize table is a select chain over the weight
    value, as in the reference (a weight outside [1, w_max] reads entry 0),
    and the probabilities are float32 ``f32(mu) * F[w]``."""
    w = w.to(torch.int32)
    xs = x.to(torch.int32)[:, :, None]
    zs = z.to(torch.int32)[:, None, :]
    x_fired = xs < T
    z_fired = zs < T
    capture = x_fired & z_fired & (xs <= zs)
    backoff = (x_fired & z_fired & (xs > zs)) | (~x_fired & z_fired)
    search = x_fired & ~z_fired

    f = torch.full(w.shape, table[0], dtype=torch.float32, device=w.device)
    for wv in range(1, w_max + 1):
        f = torch.where(w == wv, torch.tensor(table[wv], dtype=torch.float32,
                                              device=w.device), f)
    f = f[None]  # (1, Pt, q)

    p_up = capture * (mu_capture * f) + search * torch.tensor(
        mu_search, dtype=torch.float32, device=w.device)
    p_dn = backoff * (mu_backoff * f)
    inc = (uu < p_up).to(torch.int32).sum(dim=0, dtype=torch.int32)
    dec = (ud < p_dn).to(torch.int32).sum(dim=0, dtype=torch.int32)
    return inc - dec
