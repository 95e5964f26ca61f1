"""Multi-column TNN layers, as in ``repro.core.layer``.

A layer holds ``n_cols`` identical (p, q) columns; its weights are one
``(n_cols, p, q)`` int8 tensor, and the column axis is a batch axis of the
plain functions. The backend follows ``ColumnConfig.impl``, as in the
reference: ``"direct"`` and ``"matmul"`` run the plain column functions
over every column at once; ``"pallas"`` runs the layer through the
per-layer Hopper kernels of ``kernels.ops`` (one launch for the forward,
one for STDP). ``"fused"`` is a network-level fusion that ``core.network``
dispatches to the wave kernel; at layer granularity it is ``"pallas"``,
which is also the route of a fused network the wave kernel cannot hold.

Also the receptive-field plumbing of the MNIST prototype: 4x4 pixel patches
x {on, off} = 32 synapses per column, 25x25 = 625 sites over 28x28.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import random as _random
from repro_torch.core.column import (
    ColumnConfig, body_potential, column_forward_matmul, crossing_time,
    wta_inhibit,
)
from repro_torch.core.stdp import (
    apply_net, gauss_update, seq_update, stdp_net_from_uniforms,
)
from repro_torch.core.temporal import SPIKE_DTYPE, WaveSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as _kops
from repro_torch.kernels import threefry as _kthreefry

KERNEL_IMPLS = ("pallas", "fused")  # per-layer backends that launch kernels


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


def init_layer(key, cfg: LayerConfig, device="cuda") -> torch.Tensor:
    """(n_cols, p, q) int8 weights in [0, w_max], as the reference's
    ``init_layer``: column ``c`` is ``init_weights(split(key, n_cols)[c])``.
    Drawn on the host and moved to ``device`` (the card unless the caller
    names the CPU)."""
    dev = resolve_device(device)
    c = cfg.column
    keys = _random.split(key, cfg.n_cols)
    return _random.randint(keys, (c.p, c.q), 0, c.wave.w_max + 1,
                           torch.int8).to(dev)


def layer_forward(x: torch.Tensor, w: torch.Tensor, cfg: LayerConfig) -> torch.Tensor:
    """x: (B, n_cols, p) -> post-WTA spike times (B, n_cols, q) uint8."""
    spec = cfg.column.wave
    theta = cfg.column.theta
    if cfg.column.impl in KERNEL_IMPLS:
        z = _kops.layer_forward_fused(x, w, theta=theta, T=spec.T)
        return z.to(SPIKE_DTYPE)
    xc = x.transpose(0, 1)                                # (C, B, p)
    if cfg.column.impl == "matmul":
        z = column_forward_matmul(xc, w, theta, spec)
    else:
        z = crossing_time(body_potential(xc, w, spec), theta, spec)
    return wta_inhibit(z, spec).transpose(0, 1)


def layer_uniforms(key, cfg: LayerConfig, B: int, device="cuda",
                   window: Optional[Tuple[int, int, int, int]] = None) -> torch.Tensor:
    """One wave's STDP uniforms for a whole layer: (n_cols, 2, B, p, q)
    float32 in [0, 1), u[:, 0] = up and u[:, 1] = down, the reference's
    draws bit for bit: column ``c`` is ``uniform(split(key, n_cols)[c],
    (2, B, p, q))``. On the card one ``kernels.threefry`` launch draws them
    there; on the CPU its plain version does.

    ``window = (col0, n_local, row0, b_local)`` draws only one mesh rank's
    part, (n_local, 2, b_local, p, q): the columns from ``col0`` (1.0 past
    ``n_cols``, the pad sites) and the rows from ``row0`` of the global
    draw over ``B`` rows (``kernels.threefry.window_uniforms``)."""
    p, q = cfg.column.p, cfg.column.q
    if window is not None:
        return _kthreefry.window_uniforms(key, cfg.n_cols, B, (p, q), window,
                                          device=device)
    return _kthreefry.layer_uniforms(key, cfg.n_cols, (2, B, p, q),
                                     device=device)


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
    :func:`repro_torch.core.stdp.apply_net`. ``"pallas"``/``"fused"`` run
    the STDP kernel in net mode, the others the plain counter form."""
    spec, stdp = cfg.column.wave, cfg.column.stdp
    stdp.require_counter_form()
    if cfg.column.impl in KERNEL_IMPLS:
        return _stdp_kernel(x, z, w, cfg, u_up, u_dn, out="net")
    return stdp_net_from_uniforms(
        w, x.transpose(0, 1), z.transpose(0, 1), u_up, u_dn, spec, stdp)


def _stdp_kernel(x, z, w, cfg: LayerConfig, u_up, u_dn, *, out: str) -> torch.Tensor:
    """The layer's STDP through the per-layer kernel (``kernels.ops``)."""
    spec, stdp = cfg.column.wave, cfg.column.stdp
    return _kops.layer_stdp_fused(
        w, x, z, u_up, u_dn, T=spec.T, w_max=spec.w_max,
        table=stdp.table_tuple(spec), mu_capture=stdp.mu_capture,
        mu_backoff=stdp.mu_backoff, mu_search=stdp.mu_search, out=out)


def layer_step(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: LayerConfig,
    rng=None,
    learn: bool = True,
    *,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gamma wave for the whole layer: x (B, n_cols, p) -> (post-WTA
    spike times (B, n_cols, q) uint8, new int8 weights).

    The STDP update follows ``cfg.column.stdp.batch_reduce``. "sum" draws
    the layer's (n_cols, 2, B, p, q) uniforms from the key ``rng`` with
    :func:`layer_uniforms`, as the reference does, unless they are given as
    ``uniforms``; ``"pallas"``/``"fused"`` apply the update in the STDP
    kernel (``out="weights"``), the others apply the plain counters with
    ``apply_net``. "seq" and "gauss" draw their own randomness from ``rng``
    (:func:`layer_mode_update`). Every backend is bit-exact with the
    reference's update on the same key."""
    z = layer_forward(x, w, cfg)
    if not learn:
        return z, w
    if cfg.column.stdp.batch_reduce != "sum":
        if uniforms is not None:
            raise ValueError(
                f"uniforms= are the 'sum' form's draws; batch_reduce="
                f"{cfg.column.stdp.batch_reduce!r} draws its own from rng")
        if rng is None:
            raise ValueError("learning requires rng")
        return z, layer_mode_update(x, z, w, cfg, rng)
    if uniforms is None:
        if rng is None:
            raise ValueError("learning requires rng or uniforms")
        uniforms = layer_uniforms(rng, cfg, x.shape[0], x.device)
    u_up, u_dn = uniforms[:, 0], uniforms[:, 1]
    if cfg.column.impl in KERNEL_IMPLS:
        w_new = _stdp_kernel(x, z, w, cfg, u_up, u_dn, out="weights")
        return z, w_new.to(torch.int8)
    return z, apply_net(w, layer_stdp_net(x, z, w, cfg, u_up, u_dn),
                        cfg.column.wave)


def layer_mode_update(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                      cfg: LayerConfig, rng) -> torch.Tensor:
    """The "seq" or "gauss" update of a whole layer (x (B, C, p), z (B, C,
    q), w (C, p, q)) from the layer key, as the reference's per-column
    ``stdp_update`` over ``split(rng, n_cols)``, on every backend in the
    mode's plain form (no STDP kernel takes these modes). The draws run on
    x's device: "seq" one (C, B, 2, p, q) two-level draw (column c, image
    b from ``split(split(rng, C)[c], B)[b]``), "gauss" one (C, p, q) draw
    turned into normals; on the card each is one ``kernels.threefry``
    launch."""
    spec, stdp = cfg.column.wave, cfg.column.stdp
    C, p, q = w.shape
    xc, zc = x.transpose(0, 1), z.transpose(0, 1)
    if stdp.batch_reduce == "seq":
        u = _kthreefry.nested_uniforms(rng, C, x.shape[0], (2, p, q),
                                       device=x.device)
        return seq_update(w, xc, zc, u, spec, stdp)
    if stdp.batch_reduce == "gauss":
        g = _random.unit_to_normal(
            _kthreefry.layer_uniforms(rng, C, (p, q), device=x.device))
        return gauss_update(w, xc, zc, g, spec, stdp)
    raise ValueError(f"unknown batch_reduce: {stdp.batch_reduce}")


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
