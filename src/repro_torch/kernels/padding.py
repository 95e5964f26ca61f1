"""Launch geometry and padding plans, as in ``repro.kernels.padding``.

The no-op pad encodings are the reference's:

  - padded *spike times* are ``T`` ("no spike"): a ramp that never starts
    adds 0 to every body potential, and (x=T, z=T) is no STDP case;
  - padded *weight rows* are 0;
  - padded *STDP uniforms* are 1.0: ``u < p`` never fires.

The Hopper wave kernel masks a ragged batch itself and needs no padding;
:class:`PadPlan` still records the logical extents, and the serving engine
pads partial waves of requests to its fixed slot count through
:func:`pad_batch_rows`. :class:`MeshSpec` cuts a (data, model) mesh rank's
windows out of the global tensors with the same encodings.

:func:`network_plan` carries the wave kernel's forward launch extents (rows
per batch chunk, warps per block) tuned for this exact geometry by
``kernels.autotune`` on the card, looked up in the port's own cache
(``kernels/tuned_blocks.json``) by :func:`plan_geometry_key`, the
reference's key; a geometry without an entry keeps the kernel's static
rule. The reference's TPU-tuned ``benchmarks/tuned_blocks.json`` is never
read.
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
# The (data, model) mesh: one rank's windows of the global tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The sharding contract of every meshed step, the engine and the
    trainer, as the reference's ``MeshSpec``: the shards on each axis, the
    logical site count padded up to a model-axis multiple with the no-op
    encodings (pad spikes = ``T``, pad weights = 0, pad uniforms = 1.0, so a
    pad site starts no ramp, wins no WTA and fires no STDP case: its weights
    stay 0 and slicing it off is lossless), and THIS rank's place on the
    grid. Where the reference hands PartitionSpecs to ``shard_map``, a rank
    here cuts its own windows out of the global tensors: batch rows
    ``[d * b_local, (d + 1) * b_local)`` and sites ``[m * local_cols,
    (m + 1) * local_cols)`` of the padded extent; :meth:`assemble` rebuilds
    the global, unpadded tensor from every rank's window."""

    n_data: int = 1
    n_model: int = 1
    n_cols: int = 0                       # logical (global) site count
    data_index: int = 0                   # this rank's d
    model_index: int = 0                  # this rank's m

    @classmethod
    def from_mesh(cls, mesh, n_cols: int) -> "MeshSpec":
        """The spec of ``mesh`` (a ``launch.mesh.Mesh2D``; ``None`` is the
        unsharded spec) for ``n_cols`` logical sites, at this rank."""
        if mesh is None:
            return cls(n_cols=n_cols)
        return cls(n_data=mesh.n_data, n_model=mesh.n_model, n_cols=n_cols,
                   data_index=mesh.data_index, model_index=mesh.model_index)

    # -- site geometry -------------------------------------------------------

    @property
    def padded_cols(self) -> int:
        """Site extent padded up to a model-axis multiple."""
        return pad_to(self.n_cols, self.n_model)

    @property
    def local_cols(self) -> int:
        """Sites per model shard."""
        return self.padded_cols // self.n_model

    @property
    def site_pad(self) -> int:
        """No-op pad sites appended so the model axis divides evenly."""
        return self.padded_cols - self.n_cols

    @property
    def site0(self) -> int:
        """This rank's first (padded) site."""
        return self.model_index * self.local_cols

    def local_rows(self, rows: int) -> int:
        """Rows per data shard of a ``rows``-row batch."""
        if rows % self.n_data:
            raise ValueError(f"batch of {rows} rows not divisible by data "
                             f"axis size {self.n_data}")
        return rows // self.n_data

    def uniform_window(self, layer_cols: int, b_local: int) -> Tuple[int, int, int, int]:
        """``(col0, n_local, row0, b_local)`` of this rank's STDP uniforms
        for a layer of ``layer_cols`` sites: the local sites when the model
        axis shards them, else the whole layer; the local rows."""
        if self.n_model > 1:
            return (self.site0, self.local_cols, self.data_index * b_local, b_local)
        return (0, layer_cols, self.data_index * b_local, b_local)

    # -- no-op site padding / slicing ------------------------------------------

    def pad_spike_sites(self, x: torch.Tensor, T: int, *, axis: int) -> torch.Tensor:
        """Pad the site axis of encoded spikes with ``T`` ("no spike")."""
        return _pad_axis(x, axis, self.site_pad, T)

    def slice_sites(self, arr: torch.Tensor, *, axis: int) -> torch.Tensor:
        """Drop the pad sites again (inverse of the pad_* helpers)."""
        if not self.site_pad:
            return arr
        return arr.narrow(axis, 0, self.n_cols)

    def pad_weights(self, params) -> list:
        """Pad every layer's site axis (axis 0) with 0-weight no-op sites."""
        return [_pad_axis(w, 0, self.site_pad, 0) for w in params]

    # -- this rank's windows ---------------------------------------------------

    def local_weights(self, params) -> list:
        """This rank's site slice of every layer's (global, logical) weights,
        padded with 0: new contiguous tensors the train steps may update in
        place (a rank never holds a view of the global tensor)."""
        if self.n_model > 1:
            params = [w.narrow(0, self.site0, self.local_cols)
                      for w in self.pad_weights(params)]
        return [w.clone(memory_format=torch.contiguous_format) for w in params]

    def local_spikes(self, x: torch.Tensor, T: int, *, row_axis: int = 0,
                     site_axis: int = 1) -> torch.Tensor:
        """This rank's (rows, sites) window of global encoded spikes, the
        sites padded with ``T``."""
        b = self.local_rows(x.shape[row_axis])
        x = x.narrow(row_axis, self.data_index * b, b)
        if self.n_model > 1:
            x = self.pad_spike_sites(x, T, axis=site_axis).narrow(
                site_axis, self.site0, self.local_cols)
        return x.contiguous()

    def assemble(self, pieces, *, row_axis: int, site_axis: int) -> torch.Tensor:
        """The global, unpadded tensor from every rank's window, ``pieces``
        in rank order (rank ``d * n_model + m`` holds window (d, m))."""
        if len(pieces) != self.n_data * self.n_model:
            raise ValueError(f"{len(pieces)} windows for a "
                             f"{self.n_data}x{self.n_model} mesh")
        rows = [torch.cat(pieces[d * self.n_model:(d + 1) * self.n_model],
                          dim=site_axis) for d in range(self.n_data)]
        return self.slice_sites(torch.cat(rows, dim=row_axis), axis=site_axis)


def pad_uniform_sites(u: torch.Tensor, padded_cols: int) -> torch.Tensor:
    """Pad the leading site axis of per-layer STDP uniforms up to
    ``padded_cols`` with the no-op 1.0 (``u < p`` never fires)."""
    return _pad_axis(u, 0, padded_cols - u.shape[0], 1.0)


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
    # The forward wave's launch extents (rows per chunk, warps per block)
    # from the tuned cache; None = the kernel's static rule.
    launch: Optional[Tuple[int, int]] = None

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


def plan_geometry_key(cfg, batch: int, n_cols: Optional[int] = None) -> str:
    """The reference's name of a fused-wave launch geometry, letter for
    letter: the lookup key of the tuned cache. It covers only what changes
    the launch shape (sites, per-layer extents, T, batch, packed IO), not
    thresholds or STDP rates. ``n_cols`` overrides the config's site count:
    a model-sharded step launches over its local sites, another geometry."""
    first = cfg.layers[0]
    C = first.n_cols if n_cols is None else n_cols
    ps = "x".join(str(l.column.p) for l in cfg.layers)
    qs = "x".join(str(l.column.q) for l in cfg.layers)
    packed = int(bool(getattr(cfg, "packed", False)))
    return (f"C{C}_p{ps}_q{qs}_T{first.column.wave.T}"
            f"_B{batch}_packed{packed}")


# The batch tile of the plan's pad geometry (the reference's untuned
# default). The Hopper kernel chooses its own batch chunk at launch.
BLOCK_B = 64
# ``network_plan(launch=STATIC)``: the kernel's static rule, cache unread.
STATIC = (0, 0)


@functools.lru_cache(maxsize=64)
def network_plan(cfg, batch: int, n_cols: Optional[int] = None,
                 launch: Optional[Tuple[int, int]] = None) -> NetworkPlan:
    """The fused wave's plan for ``(cfg, batch)``, cached on the frozen
    config. ``n_cols`` overrides the config's site count. ``launch=None``
    looks the geometry up in the tuned cache (``kernels.autotune``) and
    keeps the static rule where it has no entry; an explicit ``(rows,
    warps)`` bypasses the cache, and :data:`STATIC` is the static rule."""
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
    if launch is None:
        from repro_torch.kernels import autotune

        launch = autotune.lookup(plan_geometry_key(cfg, batch, n_cols))
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
        launch=None if launch in (None, STATIC) else tuple(launch),
    )
