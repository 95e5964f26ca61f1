"""Plain PyTorch versions of the column bodies the reference's kernels share
(``repro.kernels.tnn_column``): the RNL body potential as the A@N 0/1
product, and threshold crossing + WTA. The Hopper wave kernel
(``csrc/tnn_wave.cu``) inlines the same arithmetic in its integer form;
the per-layer column kernel that would call these is not ported yet.

The reference runs the product in bf16 with float32 accumulation; every
entry of A and N is 0 or 1, so the float32 product here is the same exact
integer count.
"""
from __future__ import annotations

import torch


def ramp_matmul(x: torch.Tensor, w: torch.Tensor, *, T: int) -> torch.Tensor:
    """One tile's RNL body potential as the A@N product.

    x (Bt, Pt) spike times; w (Pt, q) weights -> (Bt*T, q) float32 with
    row ``b*T + t``:  V[b, t, j] = sum_{i,k} [x[b,i] + k <= t] * [k <= w[i,j]].
    """
    bt, p_tile = x.shape
    q = w.shape[1]
    dev = x.device
    k = torch.arange(1, T + 1, dtype=torch.int32, device=dev)      # ramp step
    t = torch.arange(T, dtype=torch.int32, device=dev)             # wave position
    arrive = x.to(torch.int32)[:, :, None] + k                     # (Bt, Pt, T)
    a = (arrive.reshape(bt, 1, p_tile * T) <= t[None, :, None]).to(torch.float32)
    n = (k[None, :, None] <= w.to(torch.int32)[:, None, :]).to(torch.float32)
    return a.reshape(bt * T, p_tile * T) @ n.reshape(p_tile * T, q)


def crossing_wta(V: torch.Tensor, *, T: int, theta: int, wta: bool) -> torch.Tensor:
    """Threshold crossing + optional WTA: V (Bt, T, q) -> (Bt, q) int32
    spike times; under WTA the earliest spike wins, ties to the lowest
    index."""
    bt, _, q = V.shape
    tt = torch.arange(T, dtype=torch.int32, device=V.device)[None, :, None]
    z = torch.where(V >= theta, tt, T).amin(dim=1)  # (Bt, q)
    if wta:
        qi = torch.arange(q, dtype=torch.int32, device=V.device)[None, :]
        key = z * q + qi
        winner = key.amin(dim=1, keepdim=True)
        z = torch.where((key == winner) & (z < T), z, T)
    return z.to(torch.int32)
