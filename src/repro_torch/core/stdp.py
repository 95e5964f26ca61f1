"""Unsupervised STDP with weight-dependent stabilization, counter form.

Mirrors ``repro.core.stdp``. The four timing cases (x = input spike time,
z = post-WTA output spike time, T = no spike):

    capture   x <= z, both spike     w += 1   with prob  mu_capture * F[w]
    backoff   x >  z, both spike     w -= 1   with prob  mu_backoff * F[w]
    search    x spikes, z doesn't    w += 1   with prob  mu_search
    backoff   z spikes, x doesn't    w -= 1   with prob  mu_backoff * F[w]

Only the batched ``"sum"`` counter form is ported: the uniforms come in as
tensors, so the update is a deterministic function of its inputs. The
``"seq"`` and ``"gauss"`` reduce modes draw their own randomness and are
rejected until the port has the reference's random-number generator.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

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

    def require_sum(self) -> None:
        if self.batch_reduce != "sum":
            raise ValueError(
                f"batch_reduce={self.batch_reduce!r} is not ported: only the "
                f"'sum' counter form is ('seq'/'gauss' draw their own "
                f"randomness and wait for the random-number generator port)")


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
    cfg.require_sum()
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
