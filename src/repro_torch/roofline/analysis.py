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
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models import model as lm_model
from repro_torch.models.params import is_spec, tree_flatten


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

# The same card against its dense bf16 tensor-core rate (989 TFLOP/s), the
# rate an LM's products run at (``lm_mfu``); the LM rows of the dry run are
# priced against it.
H100_SXM_BF16 = MachineProfile("h100-sxm-bf16", peak_flops=989e12, hbm_bw=3.35e12,
                               ici_bw=450e9)

PROFILES: Dict[str, MachineProfile] = {p.name: p for p in (H100_SXM, H100_SXM_BF16,
                                                           CPU_HOST)}

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
    KV head (GQA, the decoder's self-attention, and each invocation of
    zamba2's shared attention, which has its own cache), or the latent and
    the RoPE key (MLA); recurrent blocks hold none."""
    kv = 2 * cfg.n_kv_heads * cfg.head_dim
    per_layer = {"dense": kv, "moe": kv, "shared_attn": kv, "dec": kv,
                 "mla": cfg.kv_lora_rank + cfg.qk_rope_dim}
    return cache_bytes * sum(per_layer.get(k, 0) for k in cfg.layer_kinds)


def lm_state_bytes_per_row(cfg, cache_bytes: int = 2) -> int:
    """Recurrent state one row holds over all layers, which a decode step
    reads and writes: Mamba's float32 (heads, N, P) state and its (K - 1)
    conv window in the cache dtype; the mLSTM's float32 matrix memory and
    normaliser; the sLSTM's four float32 vectors."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.n_heads
    dk = d_in // max(H, 1)
    per_layer = {
        "mamba": 4 * d_in * cfg.ssm_state
        + cache_bytes * (cfg.conv_width - 1) * (d_in + 2 * cfg.ssm_state),
        "mlstm": 4 * H * dk * (dk + 1),
        "slstm": 4 * 4 * cfg.d_model,
    }
    return sum(per_layer.get(k, 0) for k in cfg.layer_kinds)


def lm_decode_weights(cfg) -> int:
    """Weights one decode step reads: the leaves ``init_params`` draws
    (``models.model.param_count``) but the encoder and the frontend
    projector, which decode does not run, and the embedding, of which it
    reads only the gathered rows, unless tied (the unembedding then reads it
    whole). zamba2's shared block counts once."""
    n = (lm_model.param_count(cfg) - lm_model.param_count(cfg, "encoder")
         - lm_model.param_count(cfg, "frontend_proj"))
    return n - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)


def lm_decode_work(cfg, lengths: Sequence[int], dtype_bytes: int = 2,
                   cache_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of one batched decode step of ``cfg``
    (``models.model.decode_step``) over rows attending to ``lengths``
    cached positions each (the new token's included).

    Bytes: every weight of :func:`lm_decode_weights` read once at the
    compute dtype, and the B gathered embedding rows; each row's valid
    KV-cache positions read and its new position written; each row's
    recurrent state read and written (:func:`lm_state_bytes_per_row`); the
    decoder's cross-attention cache over ``enc_seq`` read; the logits
    written. An MoE layer counts all its experts' weights (the reference's
    decode dispatch runs every expert over its capacity buffer).

    Operations: two per active weight per row (an MoE layer's
    ``experts_per_token`` experts); for each attending layer (dense, moe,
    mla, shared_attn, dec) the scores and weighted values of each cached
    position, 4 H hd a position, and the decoder's the same over
    ``enc_seq``; the linear recurrences' five a state element (decay
    multiply-add, the key-value outer product, the read-out multiply-add)."""
    B = len(lengths)
    d, v = cfg.d_model, cfg.vocab_size
    kinds = cfg.layer_kinds
    weights = lm_decode_weights(cfg)
    enc_kv = 2 * cfg.enc_seq * cfg.n_kv_heads * cfg.head_dim * kinds.count("dec")
    nbytes = (dtype_bytes * (weights + B * d)
              + lm_cache_bytes_per_position(cfg, cache_bytes) * (sum(lengths) + B)
              + B * (2 * lm_state_bytes_per_row(cfg, cache_bytes) + cache_bytes * enc_kv)
              + dtype_bytes * B * v)
    idle_experts = (kinds.count("moe") * (cfg.n_experts - cfg.experts_per_token)
                    * 3 * d * cfg.d_ff)
    attending = sum(k in lm_model.ATTENTION_KINDS for k in kinds)
    attn = 4 * cfg.n_heads * cfg.head_dim
    d_in = cfg.ssm_expand * d
    dk = d_in // max(cfg.n_heads, 1)
    state = (kinds.count("mamba") * d_in * cfg.ssm_state
             + kinds.count("mlstm") * cfg.n_heads * dk * (dk + 1))
    ops = (2 * B * (weights - idle_experts) + attn * attending * sum(lengths)
           + B * (attn * cfg.enc_seq * kinds.count("dec") + 5 * state))
    return float(nbytes), float(ops)


def lm_decode_bound(cfg, lengths: Sequence[int], dtype_bytes: int = 2,
                    cache_bytes: int = 2) -> Tuple[float, str, float]:
    """(bound ms, "bytes" or "operations", bytes-only ms) of
    :func:`lm_decode_work` on an H100 SXM."""
    nbytes, ops = lm_decode_work(cfg, lengths, dtype_bytes, cache_bytes)
    return bound(nbytes, 1e3 * ops / BF16_OPS_PER_S)


# ---------------------------------------------------------------------------
# LM training: one step of forward, backward and optimizer
# ---------------------------------------------------------------------------


def lm_train_work(cfg, opt_cfg, batch: int, seq: int) -> Dict[str, float]:
    """The least work of one train step (``train.train_step``) of a decoder
    whose layers are all "dense" or "moe" (GQA attention; no encoder, no
    frontend), as two phases, each at its own limit, and the bound their
    sum; the remat mode is the config's (``cfg.remat``), the optimizer and
    its compression the step's ``opt_cfg``:

    * products, at the dense bf16 tensor-core rate: (6 + 2 [remat full])
      operations a trunk weight a token (forward 2, backward 4, the
      recomputed forward 2), less the experts an MoE token does not visit;
      the head's 6 d V a token (its logits are never recomputed); the
      causal attention's 2 B H hd S^2 a layer forward (4 H hd per
      query-key pair, half of them masked; 4 B H hd S W under a sliding
      window W < S) times (3 + [remat full]);
    * the optimizer pass, at the HBM rate: float32 params and grads read,
      params written; AdamW's two moments (Adafactor's factored ones) read
      and written, the compression residual read and written, and the
      compute-dtype copy of every weight written for the next step.

    Counts the spec tree (``models.model.param_count``, not ``n_params()``:
    ROADMAP Queue 3 item 10). ``model_flops`` is 6 operations a weight a
    token, the embedding table left out and no recompute: the numerator of
    MFU (:func:`lm_mfu`)."""
    if not set(cfg.layer_kinds) <= {"dense", "moe"} or cfg.frontend or cfg.enc_seq:
        raise ValueError(f"lm_train_work counts dense and MoE decoders, not {cfg.name}")
    if opt_cfg.name not in ("adamw", "adafactor"):
        raise ValueError(opt_cfg.name)
    r = 1 if cfg.remat == "full" else 0
    tokens = batch * seq
    d, V = cfg.d_model, cfg.vocab_size
    idle = (cfg.layer_kinds.count("moe") * (cfg.n_experts - cfg.experts_per_token)
            * 3 * d * cfg.d_ff)
    kv = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    attn_fwd = 2 * batch * cfg.n_heads * cfg.head_dim * seq * kv * (2 if kv < seq else 1)
    ops = ((6 + 2 * r) * (lm_model.param_count(cfg, "trunk") - idle) * tokens
           + 6 * d * V * tokens + (3 + r) * attn_fwd * len(cfg.layer_kinds))
    n = lm_model.param_count(cfg)
    if opt_cfg.name == "adamw":
        moments = 2 * n
    else:
        moments = sum(math.prod(s.shape[:-1]) + math.prod(s.shape[:-2] + s.shape[-1:])
                      if len(s.shape) >= 2 else s.shape[0] + 1
                      for _, s in tree_flatten(lm_model.build_specs(cfg), is_spec))
    cast = 0 if lm_model.as_dtype(cfg.dtype) == torch.float32 else 2 * n
    nbytes = 4 * (3 * n + 2 * moments + (2 * n if opt_cfg.compress_grads else 0)) + cast
    products_ms = 1e3 * ops / BF16_OPS_PER_S
    optimizer_ms = 1e3 * nbytes / H100_SXM.hbm_bw
    embed = lm_model.param_count(cfg, "embed")
    return {"ops": float(ops), "bytes": float(nbytes), "products_ms": products_ms,
            "optimizer_ms": optimizer_ms, "bound_ms": products_ms + optimizer_ms,
            "model_flops": float(6 * (n - embed) * tokens)}


def lm_active_params(cfg) -> int:
    """Weights one token reads, from the spec tree
    (``models.model.param_count``): all of them but the experts an MoE token
    does not visit (``n_experts - experts_per_token`` of each MoE layer's
    three expert matrices)."""
    idle = (cfg.layer_kinds.count("moe") * (cfg.n_experts - cfg.experts_per_token)
            * 3 * cfg.d_model * cfg.d_ff)
    return lm_model.param_count(cfg) - idle


def lm_mfu(model_flops: float, step_s: float) -> float:
    """Model FLOP utilisation: ``model_flops`` a step over the step's
    seconds, against the dense bf16 peak."""
    return model_flops / step_s / BF16_OPS_PER_S
