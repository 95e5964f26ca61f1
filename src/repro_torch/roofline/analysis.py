"""Roofline analysis of the port's kernels and waves on one card.

Three terms per (cell x variant), in seconds per step on one card, as the
reference's ``repro.roofline.analysis`` defines them:

    compute    = operations           / peak operations per second
    memory     = bytes accessed       / HBM bandwidth
    collective = collective bytes     / inter-card link bandwidth

The peaks come from a named :class:`MachineProfile`; the default is the
NVIDIA H100 80GB HBM3 SXM (``h100-sxm``, its data sheet's figures at 700
W). There is no XLA cost analysis here, so :func:`from_counts` takes the
counts the caller computed: the byte and operation counts of each kernel
(:class:`Work`, from its shapes and, where the work depends on the data,
from this run's data) are this module's, and ``chip_smoke.py`` and
``launch/dryrun.py`` both read them.

The kernels' operations run on different units of the card: the ramp
product on the int8 tensor cores (the profile's peak), compares and selects
on the float32 lanes, the threefry hash on the INT32 lanes. A :class:`Work`
prices each operation at its unit's rate, so its time stays a lower bound;
:meth:`Work.peak_ops` turns that time back into operations at the peak rate
for ``Roofline.flops``. The collective term prices what a mesh run issued
(``utils.tracing.collectives_recorded``) with the reference's ring model
(:func:`collective_stats`, the formulas of its ``parse_collectives``) at the
profile's inter-card rate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """Peak constants of one machine class: the denominators of every
    roofline term."""

    name: str
    peak_flops: float  # operations/s per card (the matmul unit's dense rate)
    hbm_bw: float      # bytes/s per card, device-memory bandwidth
    ici_bw: float      # bytes/s per inter-card link (one direction)


# NVIDIA H100 80GB HBM3 SXM (data sheet, dense, 700 W): the int8 tensor-core
# rate (1,979 TOP/s), at which the column and wave kernels run the ramp
# product; 3.35 TB/s of HBM3; NVLink 4, 900 GB/s per card over its 18 links
# in both directions, so 450 GB/s each way through the NVSwitch.
H100_SXM = MachineProfile("h100-sxm", peak_flops=1979e12, hbm_bw=3.35e12,
                          ici_bw=450e9)

# Host-class ceilings for CPU runs of the plain path (round numbers: the
# order of machine, not a calibration of one host).
CPU_HOST = MachineProfile("cpu-host", peak_flops=1e11, hbm_bw=2e10, ici_bw=1e10)

PROFILES: Dict[str, MachineProfile] = {p.name: p for p in (H100_SXM, CPU_HOST)}

# The H100 SXM's other units (data sheet, 700 W): float32 outside the
# tensor cores, used for the STDP and WTA kernels' compares and selects; and
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz (the boost clock), for the
# threefry kernel's shifts and logic.
SCALAR_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Operations per threefry uniform that only the INT32 pipe issues: the
# rotate (SHF) and the xor (LOP3) of each of the 20 rounds, and the xor,
# shift and or that build the float. Its 32 adds (20 in the rounds, 10 key
# injections, 2 initial) are left out on purpose, a looser floor: an add
# issues either as IADD3 on the INT32 pipe or as IMAD on the FMA-heavy
# pipe, which has 64 lanes per SM too and runs beside it, and 32 adds a
# float fit there under the 43 the INT32 pipe must take.
THREEFRY_INT_OPS = 20 * 2 + 3


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    model_flops: float  # useful (algorithmic) operations per card
    collectives: Dict[str, int]
    profile: MachineProfile = H100_SXM

    @property
    def t_compute(self) -> float:
        return self.flops / self.profile.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / self.profile.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.profile.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_fraction(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at the
        bound of its slowest term: (model_flops/peak) / t_bound."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / self.profile.peak_flops) / self.t_bound

    def report(self) -> Dict[str, float]:
        return {
            "profile": self.profile.name,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.bytes_accessed,
            "collective_bytes_per_chip": self.collective_bytes,
            "model_flops_per_chip": self.model_flops,
            "useful_flop_fraction": self.useful_flop_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


# Bytes per element by the HLO type names the reference's report uses.
HLO_DTYPES = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
              torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
              torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
              torch.float64: "f64"}
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute", "broadcast", "barrier")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def wire_bytes(kind: str, result_bytes: int, g: int) -> int:
    """Modelled wire bytes per participating card of one collective, the
    reference's ring model (S = result bytes):

        all-gather:         S * (g-1)/g   (the result is the gathered whole)
        all-reduce:         2 * S * (g-1)/g (reduce-scatter + all-gather)
        reduce-scatter:     S * (g-1)     (the result is one shard)
        all-to-all:         S * (g-1)/g
        collective-permute: S             (one hop)

    and, for the two the port also issues: broadcast S * (g-1)/g (a ring
    pipeline forwards the buffer once), barrier 0. A group of one moves
    nothing."""
    if g <= 1:
        return 0
    S = result_bytes
    return {"all-gather": S * (g - 1) // g,
            "all-reduce": 2 * S * (g - 1) // g,
            "reduce-scatter": S * (g - 1),
            "all-to-all": S * (g - 1) // g,
            "collective-permute": S,
            "broadcast": S * (g - 1) // g,
            "barrier": 0}[kind]


def entry_bytes(entry) -> int:
    """Result bytes of one recorded collective."""
    n = 1
    for d in entry.shape:
        n *= int(d)
    return n * torch.empty((), dtype=entry.dtype).element_size()


def collective_stats(entries) -> CollectiveStats:
    """Wire bytes and counts by kind of the recorded collectives
    (``utils.tracing.CollectiveEntry``), groups of one left out as the
    reference's ``parse_collectives`` leaves them."""
    bytes_by = {k: 0 for k in COLLECTIVE_KINDS}
    count_by = {k: 0 for k in COLLECTIVE_KINDS}
    for e in entries:
        if e.group <= 1:
            continue
        bytes_by[e.kind] += wire_bytes(e.kind, entry_bytes(e), e.group)
        count_by[e.kind] += 1
    return CollectiveStats(bytes_by, count_by)


def from_counts(flops: float, bytes_accessed: float, model_flops: float,
                collective_bytes: float = 0.0,
                profile: MachineProfile = H100_SXM,
                collectives: Optional[Dict[str, int]] = None) -> Roofline:
    """A :class:`Roofline` from counted operations (at the profile's peak
    rate, :meth:`Work.peak_ops`), bytes and collective bytes, in place of
    the reference's ``from_compiled`` (there is no XLA cost analysis)."""
    return Roofline(flops=float(flops), bytes_accessed=float(bytes_accessed),
                    collective_bytes=float(collective_bytes),
                    model_flops=float(model_flops), collectives=dict(collectives or {}),
                    profile=profile)


# ---------------------------------------------------------------------------
# What each kernel must move and compute
# ---------------------------------------------------------------------------


def ops_ms(ramp_ops: float = 0, scalar_ops: float = 0, int_ops: float = 0) -> float:
    """Least ms for the operations on an H100 SXM: the ramp work (counted in
    the direct form whatever implements it) at the int8 tensor-core rate the
    column and wave kernels run it at, 32-bit integer hashing at the INT32
    rate, the rest at the scalar (float32) rate."""
    return 1e3 * (ramp_ops / H100_SXM.peak_flops + scalar_ops / SCALAR_OPS_PER_S
                  + int_ops / INT32_OPS_PER_S)


def bound(nbytes: float, t_ops: float) -> Tuple[float, str, float]:
    """(bound ms, what bounds it, bytes-only ms) for ``nbytes`` and an
    operations-only time from :func:`ops_ms`."""
    t_bytes = 1e3 * nbytes / H100_SXM.hbm_bw
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_bytes)


@dataclasses.dataclass
class Work:
    """The bytes one call must move (each input read once, each output
    written once) and its operations by unit."""

    bytes: float = 0
    ramp_ops: float = 0
    scalar_ops: float = 0
    int_ops: float = 0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.ramp_ops + other.ramp_ops,
                    self.scalar_ops + other.scalar_ops, self.int_ops + other.int_ops)

    @property
    def ops(self) -> float:
        return self.ramp_ops + self.scalar_ops + self.int_ops

    @property
    def ops_ms(self) -> float:
        return ops_ms(self.ramp_ops, self.scalar_ops, self.int_ops)

    def bound(self) -> Tuple[float, str, float]:
        """(bound ms, "bytes" or "operations", bytes-only ms)."""
        return bound(self.bytes, self.ops_ms)

    def peak_ops(self) -> float:
        """The operations' least time, as operations at the H100's peak
        rate: the ``flops`` of a :class:`Roofline` whose compute term is
        that time."""
        return self.ops_ms * 1e-3 * H100_SXM.peak_flops


# Elements of the plain A@N product built at a time when counting the ramp
# work of a large batch (a few hundred MB of float32 on the card)
_COUNT_ELEMS = 1 << 26


def _row_chunks(B: int, C: int, p: int, T: int):
    rows = max(1, _COUNT_ELEMS // max(1, C * p * T * T))
    return [(r, min(B, r + rows)) for r in range(0, B, rows)]


def _pre_and_post(x: torch.Tensor, w: torch.Tensor, theta: int, T: int):
    """The plain column forward's crossing times before and after the WTA,
    from one A@N product."""
    from repro_torch.kernels import tnn_column
    B, C, _ = x.shape
    q = w.shape[-1]
    V = tnn_column.ramp_matmul(x.transpose(0, 1), w, T=T).reshape(C, B, T, q)
    pre = tnn_column.crossing_wta(V, T=T, theta=theta, wta=False)
    post = tnn_column.crossing_wta(V, T=T, theta=theta, wta=True)
    return pre.transpose(0, 1), post.transpose(0, 1)


def _ticks(z_pre: torch.Tensor, T: int) -> int:
    return int(torch.where(z_pre < T, z_pre.to(torch.int64) + 1, T).sum())


def column_ops(x: torch.Tensor, w: torch.Tensor, theta: int, T: int) -> int:
    """The direct ramp form's min + add per synapse for each tick up to the
    neuron's crossing (all T ticks when it never crosses), from the data:
    x (B, C, p) spike times, w (C, p, q)."""
    B, C, p = x.shape
    ticks = 0
    for r0, r1 in _row_chunks(B, C, p, T):
        ticks += _ticks(_pre_and_post(x[r0:r1], w, theta, T)[0], T)
    return 2 * p * ticks


def column_work(x: torch.Tensor, w: torch.Tensor, theta: int, T: int) -> Work:
    """One per-layer column launch: x and w in, the int32 spike times out."""
    B, C, _ = x.shape
    return Work(bytes=x.numel() + w.numel() + 4 * B * C * w.shape[-1],
                ramp_ops=column_ops(x, w, theta, T))


def layer_works(x: torch.Tensor, ws: Sequence[torch.Tensor],
                thetas: Sequence[int], T: int) -> list:
    """:func:`column_work` of every layer of a cascade, layer ``l + 1`` on
    layer ``l``'s post-WTA output (the per-layer kernels' route)."""
    B, C, _ = x.shape
    ticks = [0] * len(ws)
    for r0, r1 in _row_chunks(B, C, max(w.shape[1] for w in ws), T):
        v = x[r0:r1]
        for l, (w, theta) in enumerate(zip(ws, thetas)):
            pre, v = _pre_and_post(v, w, theta, T)
            ticks[l] += _ticks(pre, T)
            v = v.to(torch.uint8)
    return [Work(bytes=B * C * w.shape[1] + w.numel() + 4 * B * C * w.shape[-1],
                 ramp_ops=2 * w.shape[1] * t) for w, t in zip(ws, ticks)]


def forward_work(x: torch.Tensor, ws: Sequence[torch.Tensor],
                 thetas: Sequence[int], T: int) -> Work:
    """One forward wave through the cascade (the wave kernel's forward):
    the volley and every layer's weights in, every layer's uint8 spike
    times out; the ramp work counted from this run's data, each layer on
    the previous layer's post-WTA output."""
    B, C, _ = x.shape
    nbytes = x.numel() + sum(w.numel() for w in ws) + sum(B * C * w.shape[-1]
                                                          for w in ws)
    return Work(bytes=nbytes, ramp_ops=sum(
        lw.ramp_ops for lw in layer_works(x, ws, thetas, T)))


def learn_epilogue_work(C: int, B: int, pqs: Sequence[int]) -> Work:
    """What the wave kernel's STDP-counter epilogue adds to its forward:
    the two uniform planes of every (row, synapse) in, the int32 nets out,
    and two Bernoulli compares per (row, synapse)."""
    pq = sum(pqs)
    return Work(bytes=8 * C * B * pq + 4 * C * pq, scalar_ops=2 * C * B * pq)


def stdp_work(C: int, B: int, p: int, q: int) -> Work:
    """One per-layer STDP launch: w, x, z and the two uniform tensors in,
    the int32 result out; two Bernoulli compares per (row, synapse)."""
    return Work(bytes=C * p * q + B * C * p + B * C * q + 8 * C * B * p * q
                + 4 * C * p * q, scalar_ops=2 * C * B * p * q)


def threefry_work(n_floats: int, pad_floats: int = 0) -> Work:
    """One threefry draw: the floats written (the key is two kernel
    arguments) and ``THREEFRY_INT_OPS`` INT32 operations per float; a mesh
    window's ``pad_floats`` (its pad sites' 1.0) are written unhashed."""
    return Work(bytes=4 * (n_floats + pad_floats),
                int_ops=THREEFRY_INT_OPS * n_floats)


def wta_work(numel: int) -> Work:
    """One standalone WTA launch on int32 spike times: in and out, and a
    key, a running min and a select per element."""
    return Work(bytes=8 * numel, scalar_ops=3 * numel)


def gauss_update_work(C: int, B: int, p: int, q: int) -> Work:
    """The plain "gauss" update of a layer (PyTorch ops, no kernel): the
    volleys, weights and normals in, the weights out; the three case
    counts of every (row, synapse)."""
    return Work(bytes=B * C * (p + q) + 2 * C * p * q + 4 * C * p * q,
                scalar_ops=3 * C * B * p * q)


# ---------------------------------------------------------------------------
# LM serving: one batched decode step
# ---------------------------------------------------------------------------

# The H100 SXM's dense bf16 tensor-core rate (data sheet, 700 W): the decode
# step's products run at it (their time is a few percent of the bytes').
BF16_OPS_PER_S = 989e12


def lm_cache_bytes_per_position(cfg, cache_bytes: int = 2) -> int:
    """KV-cache bytes one position holds over all layers: K and V of every
    KV head (GQA), or the latent and the RoPE key (MLA)."""
    per_layer = {"dense": 2 * cfg.n_kv_heads * cfg.head_dim,
                 "moe": 2 * cfg.n_kv_heads * cfg.head_dim,
                 "mla": cfg.kv_lora_rank + cfg.qk_rope_dim}
    return cache_bytes * sum(per_layer[k] for k in cfg.layer_kinds)


def lm_decode_work(cfg, lengths: Sequence[int], dtype_bytes: int = 2,
                   cache_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of one batched decode step of ``cfg``
    (``models.model.decode_step``) over rows attending to ``lengths``
    cached positions each (the new token's included): every weight read
    once at the compute dtype, except the embedding, of which only the B
    gathered rows are read (unless tied: the unembedding reads it whole);
    each row's valid KV-cache positions read and its new position written;
    the logits written. An MoE layer counts all its experts' weights (the
    reference's decode dispatch runs every expert over its capacity
    buffer). Operations: two per weight per row, and the scores and
    weighted values of each cached position."""
    B = len(lengths)
    d, v = cfg.d_model, cfg.vocab_size
    embed = v * d
    weights = cfg.n_params() - (0 if cfg.tie_embeddings else embed)
    per_pos = lm_cache_bytes_per_position(cfg, cache_bytes)
    nbytes = (dtype_bytes * (weights + B * d) + per_pos * (sum(lengths) + B)
              + dtype_bytes * B * v)
    active = cfg.n_active_params() - (0 if cfg.tie_embeddings else embed)
    attn = sum(4 * cfg.n_heads * cfg.head_dim for _ in cfg.layer_kinds)
    ops = 2 * B * active + attn * sum(lengths)
    return float(nbytes), float(ops)


def lm_decode_bound(cfg, lengths: Sequence[int], dtype_bytes: int = 2,
                    cache_bytes: int = 2) -> Tuple[float, str, float]:
    """(bound ms, "bytes" or "operations", bytes-only ms) of
    :func:`lm_decode_work` on an H100 SXM."""
    nbytes, ops = lm_decode_work(cfg, lengths, dtype_bytes, cache_bytes)
    return bound(nbytes, 1e3 * ops / BF16_OPS_PER_S)
