"""Temporal (spike-time) coding, as in ``repro.core.temporal``.

A value is the *time* of one spike inside a gamma wave of ``T = 2**time_bits``
ticks: ``t in [0, T)`` is a spike at tick ``t`` (earlier = stronger) and
``t == T`` is "no spike".
"""
from __future__ import annotations

import dataclasses

import torch

DEFAULT_TIME_BITS = 3

# Times live in [0, T] with T <= 128, so one unsigned byte holds every legal
# value including the "no spike" code T.
SPIKE_DTYPE = torch.uint8


@dataclasses.dataclass(frozen=True)
class WaveSpec:
    """Static gamma-wave timing: ``time_bits`` of temporal resolution and
    ``weight_bits`` of synaptic weight (paper: 3 and 3, so T=8, w_max=7)."""

    time_bits: int = DEFAULT_TIME_BITS
    weight_bits: int = 3

    @property
    def T(self) -> int:
        """Wave length in unit clocks; also the 'no spike' code."""
        return 1 << self.time_bits

    @property
    def w_max(self) -> int:
        return (1 << self.weight_bits) - 1

    def validate(self) -> None:
        if not (1 <= self.time_bits <= 7):
            raise ValueError(f"time_bits out of range: {self.time_bits}")
        if not (1 <= self.weight_bits <= 7):
            raise ValueError(f"weight_bits out of range: {self.weight_bits}")


def encode_intensity(values: torch.Tensor, spec: WaveSpec) -> torch.Tensor:
    """Encode intensities in [0, 1] as spike times (strong -> early):
    ``round((1 - v) * T)`` in float32, half to even, as uint8."""
    v = values.to(torch.float32).clamp(0.0, 1.0)
    return torch.round((1.0 - v) * spec.T).to(SPIKE_DTYPE)


def decode_time(times: torch.Tensor, spec: WaveSpec) -> torch.Tensor:
    """Inverse of :func:`encode_intensity` (no spike -> 0.0): ``1 - t / T``
    in float32, clipped to [0, 1]."""
    return (1.0 - times.to(torch.float32) / spec.T).clamp(0.0, 1.0)


def is_spike(times: torch.Tensor, spec: WaveSpec) -> torch.Tensor:
    """Boolean mask of the lines that spike within the wave."""
    return times < spec.T


def onoff_encode(values: torch.Tensor, spec: WaveSpec) -> torch.Tensor:
    """On-center/off-center two-channel encoding: the last axis doubles,
    each value's on time (``encode_intensity(v)``) followed by its off time
    (``encode_intensity(1 - v)``)."""
    on = encode_intensity(values, spec)
    off = encode_intensity(1.0 - values, spec)
    return torch.stack([on, off], dim=-1).reshape(
        *values.shape[:-1], values.shape[-1] * 2)


def ramp_response(times: torch.Tensor, weights: torch.Tensor, t, spec: WaveSpec
                  ) -> torch.Tensor:
    """Ramp-no-leak response of a synapse at wave position ``t``:
    ``min(max(t - x, 0), w)`` in int32 (``spec`` only for the reference's
    signature)."""
    del spec
    x = times.to(torch.int32)
    w = weights.to(torch.int32)
    t = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    return torch.minimum(torch.clamp_min(t - x, 0), w)
