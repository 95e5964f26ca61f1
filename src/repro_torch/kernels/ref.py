"""Plain PyTorch oracles, as in ``repro.kernels.ref``: the column semantics
in their simplest form, for exact integer checks of every kernel."""
from __future__ import annotations

import torch


def column_forward_ref(x: torch.Tensor, w: torch.Tensor, theta: int, T: int) -> torch.Tensor:
    """z[b, j] = min{t in [0,T): sum_i min(relu(t - x[b,i]), w[i,j]) >= theta} else T.

    x: (B, p) spike times in [0, T]; w: (p, q) weights. Returns (B, q) int32.
    """
    t = torch.arange(T, dtype=torch.int32, device=x.device)
    ramp = (t[None, None, :] - x.to(torch.int32)[:, :, None]).clamp_min(0)  # (B,p,T)
    resp = torch.minimum(ramp[:, :, :, None], w.to(torch.int32)[None, :, None, :])
    V = resp.sum(dim=1, dtype=torch.int32)  # (B, T, q)
    z = torch.where(V >= theta, t[None, :, None], T).amin(dim=1)
    return z.to(torch.int32)


def wta_ref(z: torch.Tensor, T: int) -> torch.Tensor:
    """Earliest spike wins, ties to lowest index, losers -> T. z: (B, q)."""
    zi = z.to(torch.int32)
    q = z.shape[-1]
    idx = torch.arange(q, dtype=torch.int32, device=z.device)
    winner = (zi * q + idx[None, :]).amin(dim=-1, keepdim=True) % q
    won = idx[None, :] == winner
    return torch.where(won & (zi < T), zi, T).to(torch.int32)


def stdp_ref(
    w: torch.Tensor,
    x: torch.Tensor,
    z: torch.Tensor,
    u_up: torch.Tensor,
    u_dn: torch.Tensor,
    table: torch.Tensor,
    mu_capture: float,
    mu_backoff: float,
    mu_search: float,
    w_max: int,
    T: int,
) -> torch.Tensor:
    """Batched-sum STDP update with explicit uniforms.

    w: (p, q); x: (B, p); z: (B, q); u_up/u_dn: (B, p, q) uniforms in [0,1);
    table: (w_max+1,) float32. Returns updated (p, q) int32 weights.
    """
    xs = x.to(torch.int32)[:, :, None]
    zs = z.to(torch.int32)[:, None, :]
    x_fired = xs < T
    z_fired = zs < T
    capture = x_fired & z_fired & (xs <= zs)
    backoff = (x_fired & z_fired & (xs > zs)) | (~x_fired & z_fired)
    search = x_fired & ~z_fired
    f = table.to(torch.float32)[w.long()][None]  # (1, p, q)
    p_up = capture * (mu_capture * f) + search * torch.tensor(
        mu_search, dtype=torch.float32, device=w.device)
    p_dn = backoff * (mu_backoff * f)
    inc = (u_up < p_up).to(torch.int32).sum(dim=0, dtype=torch.int32)
    dec = (u_dn < p_dn).to(torch.int32).sum(dim=0, dtype=torch.int32)
    return (w.to(torch.int32) + inc - dec).clamp(0, w_max).to(torch.int32)
