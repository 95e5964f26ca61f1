"""Unsupervised STDP with weight-dependent stabilization, counter form.

Mirrors ``repro.core.stdp``. The four timing cases (x = input spike time,
z = post-WTA output spike time, T = no spike):

    capture   x <= z, both spike     w += 1   with prob  mu_capture * F[w]
    backoff   x >  z, both spike     w -= 1   with prob  mu_backoff * F[w]
    search    x spikes, z doesn't    w += 1   with prob  mu_search
    backoff   z spikes, x doesn't    w -= 1   with prob  mu_backoff * F[w]

The three batch-reduce modes of the reference's ``stdp_update``:

* ``"sum"``: one counter update per wave, inc - dec summed over the batch
  from (2, B, p, q) uniforms, then one saturating apply. Its counter form
  (:func:`stdp_net_from_uniforms`, uniforms passed in) is what the kernels
  compute.
* ``"seq"``: the silicon's one image per wave. z is fixed before the scan;
  image b = 0 .. B-1 draws its (2, p, q) uniforms from ``split(key, B)[b]``
  and its +-1 update is clipped before the next image (:func:`seq_update`).
* ``"gauss"``: the binomial-moment-matched batched update: the case counts
  summed over the batch, one standard normal per synapse from the key, and
  ``round(mean + sqrt(var) * g)`` (:func:`gauss_update`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import random as _random
from repro_torch.core.temporal import WaveSpec


def default_stabilize_table(w_max: int) -> Tuple[float, ...]:
    """Inverted-U BRV table: F[w] ∝ w*(w_max-w), floor so rails stay live."""
    vals = []
    for w in range(w_max + 1):
        f = 4.0 * max(w * (w_max - w), 1) / (w_max * w_max)
        vals.append(min(f, 1.0))
    return tuple(vals)


@dataclasses.dataclass(frozen=True)
class STDPConfig:
    """STDP hyper-parameters; same fields and defaults as the reference."""

    mu_capture: float = 10.0 / 16.0
    mu_backoff: float = 6.0 / 16.0
    mu_search: float = 2.0 / 16.0
    stabilize: Tuple[float, ...] = ()
    batch_reduce: str = "sum"

    def table_tuple(self, spec: WaveSpec) -> Tuple[float, ...]:
        """The BRV table as a python tuple, one entry per weight value."""
        tab = self.stabilize or default_stabilize_table(spec.w_max)
        if len(tab) != spec.w_max + 1:
            raise ValueError(
                f"stabilize table has {len(tab)} entries, need {spec.w_max + 1}"
            )
        return tuple(float(v) for v in tab)

    def table(self, spec: WaveSpec, device=None) -> torch.Tensor:
        return torch.tensor(self.table_tuple(spec), dtype=torch.float32,
                            device=device)

    def require_sum(self, what: str) -> None:
        """Raise the reference's message where it takes only the "sum"
        form: ``what`` names the caller (a train or online step factory)."""
        if self.batch_reduce != "sum":
            raise ValueError(f"{what} requires batch_reduce='sum'")

    def require_counter_form(self) -> None:
        """The counter form's refusal, in the reference's words."""
        if self.batch_reduce != "sum":
            raise ValueError(
                f"counter-form STDP requires batch_reduce='sum', got "
                f"{self.batch_reduce!r} ('seq'/'gauss' do not decompose into "
                f"shard-additive counters)")


def stdp_cases(x: torch.Tensor, z: torch.Tensor, T: int):
    """``stdp_case_gen``: boolean (capture, backoff, search) planes.
    x: (..., p), z: (..., q) -> (..., p, q) each."""
    xs = x.to(torch.int32).unsqueeze(-1)  # (..., p, 1)
    zs = z.to(torch.int32).unsqueeze(-2)  # (..., 1, q)
    x_fired = xs < T
    z_fired = zs < T
    capture = x_fired & z_fired & (xs <= zs)
    backoff = (x_fired & z_fired & (xs > zs)) | (~x_fired & z_fired)
    search = x_fired & ~z_fired
    return capture, backoff, search


def stdp_net_from_uniforms(
    weights: torch.Tensor,
    x: torch.Tensor,
    z: torch.Tensor,
    u_up: torch.Tensor,
    u_dn: torch.Tensor,
    spec: WaveSpec,
    cfg: STDPConfig,
) -> torch.Tensor:
    """Net inc - dec counters of the batched "sum" update, before the clip.

    weights (..., p, q); x (..., B, p); z (..., B, q); u_up/u_dn
    (..., B, p, q) float32. Leading dims (for example one per column) are
    batch dims. Returns (..., p, q) int32. The Bernoulli probabilities are
    built in float32 as the reference builds them: ``f = table[w]``, then
    ``f32(mu) * f``; the compare is ``u < p`` in float32."""
    cfg.require_counter_form()
    table = cfg.table(spec, device=weights.device)
    capture, backoff, search = stdp_cases(x, z, spec.T)  # (..., B, p, q)
    f = table[weights.long()].unsqueeze(-3)              # (..., 1, p, q)
    p_up = capture * (cfg.mu_capture * f) + search * torch.tensor(
        cfg.mu_search, dtype=torch.float32, device=weights.device)
    p_dn = backoff * (cfg.mu_backoff * f)
    inc = (u_up < p_up).to(torch.int32).sum(dim=-3, dtype=torch.int32)
    dec = (u_dn < p_dn).to(torch.int32).sum(dim=-3, dtype=torch.int32)
    return inc - dec


def apply_net(weights: torch.Tensor, net: torch.Tensor, spec: WaveSpec) -> torch.Tensor:
    """Saturating counter apply: clip(w + net, 0, w_max) as int8."""
    w = weights.to(torch.int32) + net.to(torch.int32)
    return w.clamp(0, spec.w_max).to(torch.int8)


def _p_up_dn(w, capture, backoff, search, table, cfg: STDPConfig):
    """The Bernoulli probabilities of one update, in float32 and in the
    reference's order: ``f = table[w]``, ``p_up = capture * (mu_c * f) +
    search * f32(mu_s)``, ``p_dn = backoff * (mu_b * f)``."""
    f = table[w.long()]
    p_up = capture * (cfg.mu_capture * f) + search * torch.tensor(
        cfg.mu_search, dtype=torch.float32, device=w.device)
    return p_up, backoff * (cfg.mu_backoff * f)


def seq_update(weights: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
               u: torch.Tensor, spec: WaveSpec, cfg: STDPConfig) -> torch.Tensor:
    """The "seq" update from its uniforms: weights (..., p, q), x (..., B, p),
    z (..., B, q) and u (..., B, 2, p, q) float32 (image b's up and down
    draws). Images in order; each image's +-1 delta is clipped to
    [0, w_max] before the next. Returns (..., p, q) int8."""
    table = cfg.table(spec, device=weights.device)
    capture, backoff, search = stdp_cases(x, z, spec.T)  # (..., B, p, q)
    w = weights.to(torch.int32)
    for b in range(x.shape[-2]):
        p_up, p_dn = _p_up_dn(w, capture[..., b, :, :], backoff[..., b, :, :],
                              search[..., b, :, :], table, cfg)
        delta = ((u[..., b, 0, :, :] < p_up).to(torch.int32)
                 - (u[..., b, 1, :, :] < p_dn).to(torch.int32))
        w = (w + delta).clamp(0, spec.w_max)
    return w.to(torch.int8)


def gauss_update(weights: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                 g: torch.Tensor, spec: WaveSpec, cfg: STDPConfig) -> torch.Tensor:
    """The "gauss" update from its normals: weights (..., p, q), x (..., B, p),
    z (..., B, q), g (..., p, q) float32 standard normals. The case counts are
    float32 sums over the batch; mean and variance follow the reference's
    expression order, each step one float32 operation (no fused
    multiply-add: the reference's eager ops); the delta is
    ``round(mean + sqrt(var) * g)``, half to even. Returns (..., p, q) int8."""
    table = cfg.table(spec, device=weights.device)
    capture, backoff, search = stdp_cases(x, z, spec.T)
    f = table[weights.long()]
    n_cap = capture.to(torch.float32).sum(dim=-3)
    n_sea = search.to(torch.float32).sum(dim=-3)
    n_back = backoff.to(torch.float32).sum(dim=-3)
    p_cap, p_sea, p_back = cfg.mu_capture * f, cfg.mu_search, cfg.mu_backoff * f
    mean = n_cap * p_cap + n_sea * p_sea - n_back * p_back
    var = (n_cap * p_cap * (1 - p_cap) + n_sea * p_sea * (1 - p_sea)
           + n_back * p_back * (1 - p_back))
    delta = torch.round(mean + _random.sqrt32(var) * g).to(torch.int32)
    return (weights.to(torch.int32) + delta).clamp(0, spec.w_max).to(torch.int8)


def stdp_update(weights: torch.Tensor, x: torch.Tensor, z: torch.Tensor, rng,
                spec: WaveSpec, cfg: STDPConfig) -> torch.Tensor:
    """One gamma wave of STDP for one column, as the reference's
    ``stdp_update``: weights (p, q) int8, x (B?, p), z (B?, q), ``rng`` a
    key. Every mode draws its randomness from ``rng`` with
    ``repro_torch.random`` on x's device: "sum" (2, B, p, q) uniforms,
    "seq" (2, p, q) from ``split(rng, B)[b]`` per image, "gauss" one
    normal per synapse. Returns the new (p, q) int8 weights."""
    if x.dim() == 1:
        x, z = x[None], z[None]
    B, p, q = x.shape[0], weights.shape[-2], weights.shape[-1]
    dev = x.device
    if cfg.batch_reduce == "seq":
        u = _random.uniform(_random.split(rng, B), (2, p, q), dev)
        return seq_update(weights, x, z, u, spec, cfg)
    if cfg.batch_reduce == "gauss":
        return gauss_update(weights, x, z, _random.normal(rng, (p, q), dev),
                            spec, cfg)
    if cfg.batch_reduce != "sum":
        raise ValueError(f"unknown batch_reduce: {cfg.batch_reduce}")
    u = _random.uniform(rng, (2, B, p, q), dev)
    return apply_net(weights, stdp_net_from_uniforms(weights, x, z, u[0], u[1],
                                                     spec, cfg), spec)
