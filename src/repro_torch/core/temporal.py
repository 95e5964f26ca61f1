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
