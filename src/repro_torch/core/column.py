"""The TNN column: q SRM0 neurons x p RNL synapses + 1-WTA, as in
``repro.core.column``. These plain functions are the ``"direct"`` reference
of the port:

    V[..., t, j] = sum_i min(relu(t - x_i), w_ij)       (body potential)
    z_j          = first t with V[t, j] >= theta, else T  (crossing time)
    WTA          = earliest spike wins, ties to the lowest index

All arithmetic is int32, so results are exact on every device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.stdp import STDPConfig
from repro_torch.core.temporal import SPIKE_DTYPE, WaveSpec


@dataclasses.dataclass(frozen=True)
class ColumnConfig:
    """Static shape/hyper description of a p x q column (same fields and
    ``IMPLS`` as the reference, so configs compare field for field). The
    port runs ``"direct"`` and ``"fused"``; ``"matmul"`` and ``"pallas"``
    are refused by ``core.network.with_impl`` until they are ported."""

    p: int  # synapses per neuron (column fan-in)
    q: int  # neurons per column
    theta: int  # body-potential threshold
    wave: WaveSpec = WaveSpec()
    stdp: STDPConfig = STDPConfig()
    impl: str = "direct"

    IMPLS = ("direct", "matmul", "pallas", "fused")

    def validate(self) -> None:
        self.wave.validate()
        if self.impl not in self.IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; one of {self.IMPLS}")
        if self.p < 1 or self.q < 1:
            raise ValueError(f"bad column shape p={self.p} q={self.q}")
        if not (1 <= self.theta <= self.p * self.wave.w_max):
            raise ValueError(f"theta {self.theta} unreachable for p={self.p}")


def init_weights(gen: torch.Generator, p: int, q: int, spec: WaveSpec,
                 device="cpu") -> torch.Tensor:
    """Uniform-random initial weights in [0, w_max], int8. Drawn on the
    generator's device and moved to ``device``, so a CPU generator gives
    the same weights whatever device they end up on."""
    w = torch.randint(0, spec.w_max + 1, (p, q), generator=gen,
                      dtype=torch.int8, device=gen.device)
    return w.to(device)


def body_potential(x: torch.Tensor, w: torch.Tensor, spec: WaveSpec) -> torch.Tensor:
    """V[..., t, j] at every wave position t in [0, T).

    x (..., p) spike times; w (p, q), or (..., p, q) with the same leading
    dims as x minus its last batch axis broadcast (one weight matrix per
    column). Returns (..., T, q) int32. The wave is walked one tick at a
    time so the broadcast intermediate is (..., p, q), not (..., p, T, q)."""
    xi = x.to(torch.int32).unsqueeze(-1)  # (..., p, 1)
    wi = w.to(torch.int32)
    if wi.dim() > 2:
        wi = wi.unsqueeze(-3)             # (C, 1, p, q) against x (C, B, p, 1)
    out = []
    for t in range(spec.T):
        ramp = (t - xi).clamp_min(0)
        out.append(torch.minimum(ramp, wi).sum(dim=-2, dtype=torch.int32))
    return torch.stack(out, dim=-2)


def crossing_time(V: torch.Tensor, theta, spec: WaveSpec) -> torch.Tensor:
    """First wave position where V >= theta, else T. V: (..., T, q)."""
    t = torch.arange(spec.T, dtype=torch.int32, device=V.device).unsqueeze(-1)
    crossed = V >= theta
    z = torch.where(crossed, t, spec.T).amin(dim=-2)
    return z.to(SPIKE_DTYPE)


def column_forward(x: torch.Tensor, w: torch.Tensor, theta, spec: WaveSpec) -> torch.Tensor:
    """Pre-inhibition output spike times z_pre: (..., q)."""
    return crossing_time(body_potential(x, w, spec), theta, spec)


def wta_inhibit(z: torch.Tensor, spec: WaveSpec) -> torch.Tensor:
    """1-WTA lateral inhibition: the earliest spike passes, ties break to
    the LOWEST neuron index (the minimum of the unique key z*q + j), and
    every other neuron is set to T. z: (..., q)."""
    zi = z.to(torch.int32)
    q = z.shape[-1]
    idx = torch.arange(q, dtype=torch.int32, device=z.device)
    winner = (zi * q + idx).amin(dim=-1, keepdim=True) % q
    won = idx == winner
    return torch.where(won & (zi < spec.T), zi, spec.T).to(SPIKE_DTYPE)
