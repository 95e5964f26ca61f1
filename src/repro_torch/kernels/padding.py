"""Launch geometry and padding plans, as in ``repro.kernels.padding``.

The no-op pad encodings are the reference's:

  - padded *spike times* are ``T`` ("no spike"): a ramp that never starts
    adds 0 to every body potential, and (x=T, z=T) is no STDP case;
  - padded *weight rows* are 0;
  - padded *STDP uniforms* are 1.0: ``u < p`` never fires.

The Hopper wave kernel masks a ragged batch itself and needs no padding;
:class:`PadPlan` still records the logical extents, and the serving engine
pads partial waves of requests to its fixed slot count through
:func:`pad_batch_rows`. Block sizes are this port's own defaults: the
reference's tuned block cache (``benchmarks/tuned_blocks.json``) was tuned
for other hardware and is not read.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def pad_to(n: int, m: int) -> int:
    """Round ``n`` up to a multiple of ``m``."""
    return (n + m - 1) // m * m


def _pad_axis(arr: torch.Tensor, axis: int, amount: int, value) -> torch.Tensor:
    if amount == 0:
        return arr
    axis = axis % arr.dim()
    # F.pad lists (left, right) pairs from the LAST axis backwards
    widths = [0, 0] * (arr.dim() - axis)
    widths[-1] = amount
    return F.pad(arr, widths, value=value)


@dataclasses.dataclass(frozen=True)
class PadPlan:
    """One launch's geometry: logical extents, clamped blocks, padded
    extents. Frozen and hashable."""

    b: int                 # logical batch rows
    p: int                 # logical synapse rows (0 when the launch has none)
    block_b: int
    block_p: int
    bp: int                # padded batch extent (multiple of block_b)
    pp: int                # padded synapse extent (multiple of block_p)

    @classmethod
    def make(
        cls,
        b: int,
        p: Optional[int] = None,
        *,
        block_b: int = 64,
        block_p: int = 256,
        p_align: int = 8,
    ) -> "PadPlan":
        """Clamp block sizes to the aligned problem extents and compute the
        padded extents."""
        block_b = min(block_b, pad_to(b, 8))
        if p is None:
            p = block_p = pp = 0
        else:
            block_p = min(block_p, pad_to(p, max(p_align, 8)))
            pp = pad_to(p, block_p)
        return cls(b=b, p=p, block_b=block_b, block_p=block_p,
                   bp=pad_to(b, block_b), pp=pp)

    @property
    def n_b(self) -> int:
        """Batch-tile count."""
        return self.bp // self.block_b

    # -- the three no-op pad encodings -------------------------------------

    def pad_spikes(self, x: torch.Tensor, T: int, *, b_axis: Optional[int] = 0,
                   p_axis: Optional[int] = None) -> torch.Tensor:
        """Pad spike-time rows with ``T`` on the batch and/or synapse axes."""
        if b_axis is not None:
            x = _pad_axis(x, b_axis, self.bp - self.b, T)
        if p_axis is not None:
            x = _pad_axis(x, p_axis, self.pp - self.p, T)
        return x

    def pad_weights(self, w: torch.Tensor, *, p_axis: int = 0) -> torch.Tensor:
        """Pad weight rows with 0 (a zero-weight synapse is a no-op)."""
        return _pad_axis(w, p_axis, self.pp - self.p, 0)

    def pad_uniforms(self, u: torch.Tensor, *, b_axis: int = 0,
                     p_axis: Optional[int] = None) -> torch.Tensor:
        """Pad STDP uniforms with 1.0 (``u < p`` can never fire)."""
        u = _pad_axis(u, b_axis, self.bp - self.b, 1.0)
        if p_axis is not None:
            u = _pad_axis(u, p_axis, self.pp - self.p, 1.0)
        return u


def pad_batch_rows(x: torch.Tensor, rows: int, T: int) -> torch.Tensor:
    """Pad the leading (batch) axis of encoded spike times up to ``rows``
    with the no-op encoding ``T``: an all-``T`` volley starts no ramps,
    crosses no threshold and leaves the cascade still all ``T``."""
    k = x.shape[0]
    if k > rows:
        raise ValueError(f"batch of {k} rows exceeds padded extent {rows}")
    return _pad_axis(x, 0, rows - k, T)


# ---------------------------------------------------------------------------
# Network-level plan for the fused wave executor
# ---------------------------------------------------------------------------

# The fused wave keeps each column's layer-1 synapse axis in one piece, so
# padded p1 is capped; deeper fan-ins are previous layers' neuron counts
# (<= 128), so only the input-facing synapse axis needs this cap.
MAX_FUSED_P1 = 512


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """Static plan for one fused gamma wave over an N-layer same-site
    cascade: logical extents, the batch/p1 pad geometry and every
    per-layer constant, in layer order. Hashable."""

    n_cols: int
    ps: Tuple[int, ...]          # logical fan-in per layer (ps[i] = qs[i-1])
    qs: Tuple[int, ...]          # neurons per layer
    thetas: Tuple[int, ...]      # firing threshold per layer
    T: int
    w_max: int
    pad: PadPlan                 # batch axis + layer-1 synapse axis
    tables: Tuple[Tuple[float, ...], ...]          # stabilize table per layer
    mus: Tuple[Tuple[float, float, float], ...]    # (capture, backoff, search)
    # The reference's kernel-boundary dtype switch; the Hopper kernel always
    # takes uint8 volleys and int8 weights and the results are identical
    # either way, so here it only keeps configs comparable.
    packed: bool = False

    @property
    def n_layers(self) -> int:
        return len(self.qs)

    @property
    def pps(self) -> Tuple[int, ...]:
        """Padded fan-in extent per layer (only layer 1's is padded)."""
        return (self.pad.pp,) + self.ps[1:]


def fused_wave_capable(cfg) -> bool:
    """Whether ``cfg`` (a ``core.network.NetworkConfig``) has the fused wave
    executor's topology: an N-layer (N >= 1) chain of same-site layers, each
    fan-in equal to the previous layer's neuron count, one shared wave spec,
    every q <= 128 and padded p1 <= ``MAX_FUSED_P1``."""
    layers = cfg.layers
    if not layers:
        return False
    first = layers[0]
    if pad_to(first.column.p, 8) > MAX_FUSED_P1:
        return False
    prev_q = None
    for l in layers:
        if (l.n_cols != first.n_cols
                or l.column.wave != first.column.wave
                or l.column.q > 128):
            return False
        if prev_q is not None and l.column.p != prev_q:
            return False
        prev_q = l.column.q
    return True


# The batch tile of the plan's pad geometry (the reference's untuned
# default). The Hopper kernel chooses its own batch chunk at launch.
BLOCK_B = 64


@functools.lru_cache(maxsize=64)
def network_plan(cfg, batch: int, n_cols: Optional[int] = None) -> NetworkPlan:
    """The fused wave's plan for ``(cfg, batch)``, cached on the frozen
    config. ``n_cols`` overrides the config's site count."""
    if not fused_wave_capable(cfg):
        l_desc = [(l.n_cols, l.column.p, l.column.q) for l in cfg.layers]
        raise ValueError(
            f"network {l_desc} is not fused-wave capable: need same-site "
            f"layers chained so each fan-in equals the previous layer's "
            f"neuron count, a shared WaveSpec, every q <= 128 and padded "
            f"p1 <= {MAX_FUSED_P1}")
    first = cfg.layers[0]
    spec = first.column.wave
    if spec.T >= 255:
        raise ValueError(
            f"wave spec T={spec.T} overflows the packed uint8 spike-time "
            f"encoding: times live in [0, T] with T as the 'no spike' pad "
            f"code, so the data plane requires T <= 254 — use time_bits <= 7")
    pad = PadPlan.make(batch, first.column.p, block_b=BLOCK_B,
                       block_p=MAX_FUSED_P1)
    return NetworkPlan(
        n_cols=first.n_cols if n_cols is None else n_cols,
        ps=tuple(l.column.p for l in cfg.layers),
        qs=tuple(l.column.q for l in cfg.layers),
        thetas=tuple(l.column.theta for l in cfg.layers),
        T=spec.T, w_max=spec.w_max,
        pad=pad,
        tables=tuple(l.column.stdp.table_tuple(spec) for l in cfg.layers),
        mus=tuple((l.column.stdp.mu_capture, l.column.stdp.mu_backoff,
                   l.column.stdp.mu_search) for l in cfg.layers),
        packed=bool(getattr(cfg, "packed", False)),
    )
