"""Multi-column TNN layers, as in ``repro.core.layer``.

A layer holds ``n_cols`` identical (p, q) columns; its weights are one
``(n_cols, p, q)`` int8 tensor, and the column axis is a batch axis of the
plain functions. Only the ``"direct"`` path lives here: ``"fused"`` is a
network-level fusion that ``core.network`` dispatches to the wave kernel.

Also the receptive-field plumbing of the MNIST prototype: 4x4 pixel patches
x {on, off} = 32 synapses per column, 25x25 = 625 sites over 28x28.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.column import (
    ColumnConfig, body_potential, crossing_time, wta_inhibit,
)
from repro_torch.core.stdp import stdp_net_from_uniforms
from repro_torch.core.temporal import SPIKE_DTYPE, WaveSpec


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    n_cols: int
    column: ColumnConfig

    def validate(self) -> None:
        if self.n_cols < 1:
            raise ValueError(f"n_cols={self.n_cols}")
        self.column.validate()

    @property
    def n_neurons(self) -> int:
        return self.n_cols * self.column.q

    @property
    def n_synapses(self) -> int:
        return self.n_cols * self.column.p * self.column.q


def _require_direct(cfg: LayerConfig) -> None:
    if cfg.column.impl != "direct":
        raise ValueError(
            f"per-layer impl {cfg.column.impl!r} is not ported: the port's "
            f"per-layer path is 'direct' ('fused' runs whole networks "
            f"through core.network)")


def init_layer(gen: torch.Generator, cfg: LayerConfig, device="cpu") -> torch.Tensor:
    """Uniform-random (n_cols, p, q) int8 weights in [0, w_max], drawn from
    ``gen`` on its own device and moved to ``device``."""
    c = cfg.column
    w = torch.randint(0, c.wave.w_max + 1, (cfg.n_cols, c.p, c.q),
                      generator=gen, dtype=torch.int8, device=gen.device)
    return w.to(device)


def layer_forward(x: torch.Tensor, w: torch.Tensor, cfg: LayerConfig) -> torch.Tensor:
    """x: (B, n_cols, p) -> post-WTA spike times (B, n_cols, q) uint8."""
    _require_direct(cfg)
    spec = cfg.column.wave
    V = body_potential(x.transpose(0, 1), w, spec)  # (C, B, T, q)
    z = wta_inhibit(crossing_time(V, cfg.column.theta, spec), spec)
    return z.transpose(0, 1)


def layer_uniforms(gen: torch.Generator, cfg: LayerConfig, B: int,
                   device="cpu") -> torch.Tensor:
    """One wave's STDP uniforms for a whole layer: (n_cols, 2, B, p, q)
    float32 in [0, 1), u[:, 0] = up and u[:, 1] = down, drawn from ``gen``
    on its own device and moved to ``device``. The bits differ from the
    reference's threefry draws; tests hand the reference's draws across."""
    p, q = cfg.column.p, cfg.column.q
    u = torch.rand((cfg.n_cols, 2, B, p, q), generator=gen,
                   dtype=torch.float32, device=gen.device)
    return u.to(device)


def layer_stdp_net(
    x: torch.Tensor,
    z: torch.Tensor,
    w: torch.Tensor,
    cfg: LayerConfig,
    u_up: torch.Tensor,
    u_dn: torch.Tensor,
) -> torch.Tensor:
    """Net STDP counters for a whole layer, before the clip.

    x: (B, C, p) inputs; z: (B, C, q) post-WTA outputs; w: (C, p, q);
    u_up/u_dn: (C, B, p, q). Returns (C, p, q) int32; apply once with
    :func:`repro_torch.core.stdp.apply_net`."""
    _require_direct(cfg)
    return stdp_net_from_uniforms(
        w, x.transpose(0, 1), z.transpose(0, 1), u_up, u_dn,
        cfg.column.wave, cfg.column.stdp)


# ---------------------------------------------------------------------------
# Receptive-field extraction (the prototype's patch front end)
# ---------------------------------------------------------------------------


def extract_patches(images: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """(B, H, W) -> (B, sites, k*k) sliding patches (valid padding), patch
    pixels row-major and sites row-major, as the reference's
    ``conv_general_dilated_patches`` orders them."""
    cols = F.unfold(images[:, None].to(torch.float32), kernel_size=k,
                    stride=stride)  # (B, k*k, sites)
    return cols.transpose(1, 2)


def encode_patches_onoff(patches01: torch.Tensor, spec: WaveSpec) -> torch.Tensor:
    """Pixel intensities in [0,1] -> interleaved on/off spike times:
    (B, sites, px) -> (B, sites, 2*px) uint8."""
    v = patches01.clamp(0, 1)
    on = torch.round((1.0 - v) * spec.T)
    off = torch.round(v * spec.T)
    out = torch.stack([on, off], dim=-1).reshape(
        *patches01.shape[:-1], patches01.shape[-1] * 2)
    return out.to(SPIKE_DTYPE)
