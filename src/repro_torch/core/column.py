"""The TNN column: q SRM0 neurons x p RNL synapses + 1-WTA, as in
``repro.core.column``. These plain functions are the ``"direct"`` reference
of the port:

    V[..., t, j] = sum_i min(relu(t - x_i), w_ij)       (body potential)
    z_j          = first t with V[t, j] >= theta, else T  (crossing time)
    WTA          = earliest spike wins, ties to the lowest index

All arithmetic is int32, so results are exact on every device.
:func:`column_forward_matmul` is the ``"matmul"`` backend, the same
potential as a 0/1 product (exact in float32). :func:`column_step` is one
whole gamma wave of a column: forward, WTA and, when it learns, STDP.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import random as _random
from repro_torch.core.stdp import STDPConfig, stdp_update
from repro_torch.core.temporal import SPIKE_DTYPE, WaveSpec
from repro_torch.device import resolve_device
from repro_torch.kernels.tnn_column import ramp_matmul


@dataclasses.dataclass(frozen=True)
class ColumnConfig:
    """Static shape/hyper description of a p x q column (same fields and
    ``IMPLS`` as the reference, so configs compare field for field). The
    backends, all exactly equal:

    * ``"direct"``: the plain broadcast evaluation below;
    * ``"matmul"``: :func:`column_forward_matmul`, the 0/1 product form;
    * ``"pallas"``: the per-layer Hopper kernels of ``kernels.ops``
      (forward + WTA, and STDP, one launch each per layer);
    * ``"fused"``: the whole-network wave kernel (``kernels.tnn_wave``), one
      launch per gamma wave; a network outside its topology runs layer by
      layer as ``"pallas"``."""

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


def init_weights(key, p: int, q: int, spec: WaveSpec,
                 device="cuda") -> torch.Tensor:
    """Uniform-random initial weights in [0, w_max], int8: the reference's
    ``jax.random.randint(key, (p, q), 0, w_max + 1, int8)`` bit for bit
    (``repro_torch.random``). Drawn on the host and moved to ``device`` (the
    card unless the caller names the CPU)."""
    dev = resolve_device(device)
    return _random.randint(key, (p, q), 0, spec.w_max + 1, torch.int8).to(dev)


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


def column_forward_matmul(x: torch.Tensor, w: torch.Tensor, theta,
                          spec: WaveSpec) -> torch.Tensor:
    """The ``"matmul"`` backend: the body potential as the A@N 0/1 product
    (``kernels.tnn_column.ramp_matmul``), then the crossing time. x (..., p)
    against w (p, q), or x (C, B, p) against per-column w (C, p, q) ->
    (..., q). Every sum is at most p*T, so the float32 product is exact
    (also in TF32, whose inputs hold 0 and 1 exactly). The reference
    computes it in XLA outside any Pallas kernel, as a PyTorch product does
    here."""
    rows = x if w.dim() > 2 else x.reshape(-1, x.shape[-1])
    V = ramp_matmul(rows, w, T=spec.T).reshape(*x.shape[:-1], spec.T, w.shape[-1])
    return crossing_time(V.to(torch.int32), theta, spec)


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


def column_step(x: torch.Tensor, w: torch.Tensor, cfg: ColumnConfig, rng=None,
                learn: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full gamma wave, as the reference's ``column_step``: forward ->
    WTA -> (optionally) STDP (``core.stdp.stdp_update`` in ``cfg.stdp``'s
    mode, its randomness drawn from the key ``rng`` on x's device).

    x: (B?, p) uint8 spike times; w: (p, q) int8. Returns (z_out (B?, q)
    uint8 post-WTA spike times, new weights)."""
    z_pre = column_forward(x, w, cfg.theta, cfg.wave)
    z_out = wta_inhibit(z_pre, cfg.wave)
    if learn:
        if rng is None:
            raise ValueError("learning step requires an rng key")
        w = stdp_update(w, x, z_out, rng, cfg.wave, cfg.stdp)
    return z_out, w
