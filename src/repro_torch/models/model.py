"""Model builder: ParamSpec trees + train/prefill/decode forwards for every
architecture family of the registry (dense GQA, MLA, MoE + SWA, xLSTM,
Mamba2 hybrid with shared attention, encoder-decoder, VLM prefix), as
``repro.models.model`` builds and runs them.

The tree layout is the reference's, name for name: ``embed``, ``trunk``
(one repeating unit of block kinds, its leaves stacked on a leading layers
axis), ``tail`` (unstacked blocks after the trunk), ``shared`` (zamba2's
attention block, stored once and invoked by every ``shared_attn`` slot of
the unit, whose own spec is empty), ``final_norm``, ``head`` (unless
tied), ``encoder`` (its own stacked trunk and final norm) and
``frontend_proj`` (stub modality projector). Where the reference scans the
stacked layers, the port loops over them in Python. Caches keep the
reference's layout too (``{"trunk": {"0_dense": (k, v)}, "tail": ...}``,
each trunk leaf (layers, B, ...), each tail leaf (B, ...)), and the
forwards write them in place. Recurrent states are float32 whatever the
cache dtype (``models.ssm``).

Modes:
    train   — full-sequence causal forward, logits for CE loss; under
              autograd each trunk unit and encoder layer runs under
              activation checkpointing by ``cfg.remat``, where the
              reference wraps them in ``jax.checkpoint``
    prefill — full-sequence forward that also fills the caches
    decode  — one token against pre-allocated caches (serve_step)

``embeds`` (B, P, d) are precomputed frontend embeddings, projected by
``frontend_proj`` and prefixed to the tokens (the VLM); ``frames``
(B, enc_seq, d) go through the encoder, whose output the decoder's
cross-attention reads (encdec). Each forward can also return the trunk
increment: the residual stream after the trunk (and the tail), before
``final_norm``, minus the trunk's input (the embedded tokens, after any
prefix), in float32 (at the reference's random weights the logits barely
see the trunk, so parity checks compare this too).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import (
    ParamSpec, is_spec, leaf_keys, stack_specs, tree_abstract, tree_axes, tree_flatten,
    tree_init, tree_map, tree_map_with_path,
)
from repro_torch.sharding.context import shard_activation
from repro_torch.sharding.partition import is_sharded, local

# block kinds whose decode attends to a KV cache
ATTENTION_KINDS = ("dense", "moe", "mla", "shared_attn", "dec")
RECURRENT_KINDS = ("mamba", "mlstm", "slstm")


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


def _attn_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.gqa_spec(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act),
    }


def _block_spec(kind: str, cfg: ModelConfig) -> Dict[str, Any]:
    if kind in ("dense", "enc"):
        return _attn_block_spec(cfg)
    if kind == "moe":
        return {
            "ln1": L.rmsnorm_spec(cfg.d_model),
            "attn": L.gqa_spec(cfg),
            "ln2": L.rmsnorm_spec(cfg.d_model),
            "moe": MOE.moe_spec(cfg),
        }
    if kind == "mla":
        return {
            "ln1": L.rmsnorm_spec(cfg.d_model),
            "attn": L.mla_spec(cfg),
            "ln2": L.rmsnorm_spec(cfg.d_model),
            "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act),
        }
    if kind == "mamba":
        return {"ln": L.rmsnorm_spec(cfg.d_model), "mamba": SSM.mamba_spec(cfg)}
    if kind == "mlstm":
        return {"ln": L.rmsnorm_spec(cfg.d_model), "mlstm": SSM.mlstm_spec(cfg)}
    if kind == "slstm":
        return {"ln": L.rmsnorm_spec(cfg.d_model), "slstm": SSM.slstm_spec(cfg)}
    if kind == "shared_attn":
        return {}  # the weights live once in params["shared"]
    if kind == "dec":
        return {
            "ln1": L.rmsnorm_spec(cfg.d_model),
            "attn": L.gqa_spec(cfg),
            "lnx": L.rmsnorm_spec(cfg.d_model),
            "xattn": L.gqa_spec(cfg),
            "ln2": L.rmsnorm_spec(cfg.d_model),
            "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act),
        }
    raise ValueError(f"unknown block kind {kind}")


def build_specs(cfg: ModelConfig) -> Dict[str, Any]:
    unit = {f"{i}_{k}": _block_spec(k, cfg) for i, k in enumerate(cfg.layout_unit)}
    specs: Dict[str, Any] = {
        "embed": L.embed_spec(cfg.vocab_size, cfg.d_model),
        "trunk": stack_specs(unit, cfg.layout_repeat),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }
    if cfg.layout_tail:
        specs["tail"] = {f"{i}_{k}": _block_spec(k, cfg)
                         for i, k in enumerate(cfg.layout_tail)}
    if "shared_attn" in cfg.layer_kinds:
        specs["shared"] = _attn_block_spec(cfg)
    if not cfg.tie_embeddings:
        specs["head"] = {
            "w": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
        }
    if cfg.n_enc_layers:
        specs["encoder"] = {
            "trunk": stack_specs({"0_enc": _block_spec("enc", cfg)}, cfg.n_enc_layers),
            "final_norm": L.rmsnorm_spec(cfg.d_model),
        }
    if cfg.frontend:
        # stub modality projector (frontend embeddings are precomputed inputs)
        specs["frontend_proj"] = {
            "w": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed_out"))
        }
    return specs


def param_count(cfg: ModelConfig, section: Optional[str] = None) -> int:
    """Floats ``init_params`` draws: the spec tree's leaves, all of them or
    those under one top-level ``section`` (``cfg.n_params()`` is the
    reference's analytic count, which differs from the tree for some
    families: ROADMAP Queue 3)."""
    specs = build_specs(cfg)
    if section is not None:
        specs = specs.get(section, {})
    return sum(math.prod(s.shape) for _, s in tree_flatten(specs, is_spec))


def init_params(cfg: ModelConfig, key, device="cuda"):
    """The reference's ``init_params(cfg, key)``, bit for bit, drawn on
    ``device`` (float32 leaves)."""
    return tree_init(build_specs(cfg), key, device)


def abstract_params(cfg: ModelConfig):
    """The param tree as ``meta`` tensors (shapes and dtypes, no storage)."""
    return tree_abstract(build_specs(cfg))


def param_axes(cfg: ModelConfig):
    """The param tree's logical axes, a tuple of names per leaf."""
    return tree_axes(build_specs(cfg))


def param_keys(cfg: ModelConfig, key) -> Dict[tuple, torch.Tensor]:
    """Each parameter's path -> the key its leaf is drawn from."""
    return leaf_keys(build_specs(cfg), key)


# leaves the reference reads in float32 whatever the compute dtype: the norm
# scales (``rmsnorm`` casts them to float32), the mLSTM gate projection, the
# sLSTM recurrence and Mamba's decay parameters
F32_LEAVES = ("scale", "q_norm", "kv_norm", "wif", "bif", "wr", "a_log", "dt_bias")


def compute_params(params, dtype) -> Any:
    """One compute copy of a param tree: every leaf in ``dtype`` except
    :data:`F32_LEAVES`, which stay as they are. The forwards then compute
    what the reference computes by casting each weight at its use; a leaf
    already in ``dtype`` is shared, not copied."""
    dt = as_dtype(dtype)
    return tree_map_with_path(
        lambda path, t: t if path[-1] in F32_LEAVES else t.to(dt), params)


def as_dtype(dtype) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[dtype]


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def _block_cache(kind: str, cfg: ModelConfig, B: int, S: int, dtype, device, lead=()):
    """One block's cache, zeros, each leaf ``lead + (B, ...)``."""
    KV, hd = cfg.n_kv_heads, cfg.head_dim

    def z(*shape):
        return torch.zeros(lead + (B,) + shape, dtype=dtype, device=device)

    if kind in ("dense", "moe"):
        Sc = min(S, cfg.sliding_window) if cfg.sliding_window else S
        return (z(Sc, KV, hd), z(Sc, KV, hd))
    if kind == "shared_attn":
        return (z(S, KV, hd), z(S, KV, hd))
    if kind == "mla":
        return (z(S, cfg.kv_lora_rank), z(S, cfg.qk_rope_dim))
    if kind == "mamba":
        return SSM.mamba_init_state(cfg, B, dtype, device, lead)
    if kind == "mlstm":
        return SSM.mlstm_init_state(cfg, B, device, lead)
    if kind == "slstm":
        return SSM.slstm_init_state(cfg, B, device, lead)
    if kind == "dec":
        # self-attention K/V, then the cross-attention K/V of the encoder
        return (z(S, KV, hd), z(S, KV, hd), z(cfg.enc_seq, KV, hd), z(cfg.enc_seq, KV, hd))
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, B: int, S: int, dtype=torch.bfloat16, device="cuda"):
    """Zero caches for ``B`` rows of ``S`` positions: the trunk's stacked over
    its layers (sliding-window layers hold a ring of ``window``), the tail's
    unstacked. Recurrent states are float32, other leaves ``dtype``.
    ``device="meta"`` gives the shapes alone (``launch.specs``)."""
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    dt = as_dtype(dtype)
    R = cfg.layout_repeat
    cache = {"trunk": {f"{i}_{k}": _block_cache(k, cfg, B, S, dt, dev, (R,))
                       for i, k in enumerate(cfg.layout_unit)}}
    if cfg.layout_tail:
        cache["tail"] = {f"{i}_{k}": _block_cache(k, cfg, B, S, dt, dev)
                         for i, k in enumerate(cfg.layout_tail)}
    return cache


def cache_axes(cfg: ModelConfig, cache) -> Any:
    """Logical axes for a cache tree (real or ``meta`` tensors): KV-like
    leaves shard (batch, kv_seq), recurrent states batch only, inferred
    structurally as the reference does: a leaf under ``trunk`` has a leading
    layers axis; Mamba's SSD state (B, heads, N, P) shards (batch, heads),
    its conv window (B, K-1, C) (batch, ., mlp); mLSTM and sLSTM states
    shard the batch only."""

    def axes_for(key: str, arr, stacked: bool):
        lead = ("layers",) if stacked else ()
        kind = key.split("_", 1)[1]
        nrest = arr.dim() - len(lead) - 1  # dims after (layers?, batch)
        if kind == "mamba":
            if nrest == 3:
                return lead + ("batch", "heads", None, None)
            return lead + ("batch", None, "mlp")
        if kind in ("mlstm", "slstm"):
            return lead + ("batch",) + (None,) * nrest
        return lead + ("batch", "kv_seq") + (None,) * (nrest - 1)

    out = {}
    for section, stacked in (("trunk", True), ("tail", False)):
        if section not in cache:
            continue
        out[section] = {key: tree_map(lambda a, k=key: axes_for(k, a, stacked), blk)
                        for key, blk in cache[section].items()}
    return out


def _store(cache, new) -> None:
    """Copy a block's new state into its cache views, in place."""
    for c, n in zip(cache, new):
        c.copy_(n)


# ---------------------------------------------------------------------------
# Block forwards
# ---------------------------------------------------------------------------


def _ffn(kind, h, p, cfg, decode: bool):
    if kind == "moe":
        if decode:
            return MOE.moe_ffn(h[:, None, :], p["moe"], cfg, n_groups=1)[:, 0]
        return MOE.moe_ffn(h, p["moe"], cfg)
    return L.mlp(h, p["mlp"], cfg.act)


def _cross_kv(enc_out, p, dt):
    return L._proj(enc_out, p["xattn"]["wk"].to(dt)), L._proj(enc_out, p["xattn"]["wv"].to(dt))


def _cross_attend(x, p, cfg, ek, ev, kv_chunk):
    """The decoder's cross-attention over the encoder output (no RoPE: the
    encoder's and decoder's positions are unrelated). Returns x."""
    h = L.rmsnorm(x, p["lnx"], cfg.norm_eps)
    q = L._proj(h, p["xattn"]["wq"].to(x.dtype))
    attn = L.flash_attention(q, ek, ev, cross=True, kv_chunk=kv_chunk)
    return x + L.gqa_out(attn, p["xattn"])


def _run_block_train(kind, x, p, cfg, positions, shared, enc_out, kv_chunk=512):
    if kind in RECURRENT_KINDS:
        h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
        run = {"mamba": SSM.mamba_train, "mlstm": SSM.mlstm_train,
               "slstm": SSM.slstm_train}[kind]
        return x + run(h, p[kind], cfg)
    if kind == "shared_attn":
        p = shared
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "mla":
        x = x + L.mla_attend_train(h, p["attn"], cfg, positions, kv_chunk)
    else:
        x = x + L.gqa_attend_train(h, p["attn"], cfg, positions, kv_chunk)
    if kind == "dec":
        x = _cross_attend(x, p, cfg, *_cross_kv(enc_out, p, x.dtype), kv_chunk)
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(kind, h, p, cfg, decode=False)


def _prefill_write(c: torch.Tensor, new: torch.Tensor) -> None:
    """Write a full prefix into the start of a cache buffer, in place (into
    a DTensor cache: each rank the rows and positions its block holds)."""
    if not is_sharded(c):
        c[:, :new.shape[1]] = new.to(c.dtype)
        return
    new_l, sl = L.rows_block(new, c)
    lo, hi = sl[1].start, min(sl[1].stop, new.shape[1])
    if hi > lo:
        local(c)[:, :hi - lo] = new_l[:, lo:hi].to(c.dtype)


def _ring_window(new: torch.Tensor, Sc: int) -> torch.Tensor:
    """The last ``Sc`` positions of ``new`` (B, S, ...) in the ring buffer's
    layout (slot = pos % Sc): the reference's ``jnp.roll`` of them by
    ``S % Sc``, as two slices joined, since DTensor has no rule for
    ``aten.roll`` in every torch release the port runs on."""
    S = new.shape[1]
    last, k = new[:, S - Sc:], S % Sc
    return torch.cat([last[:, Sc - k:], last[:, :Sc - k]], dim=1) if k else last


def _mlstm_prefill(h, p, cfg, cache):
    """The train pass, and the final state recomputed by one chunked pass
    with q = 0 from the cache's state."""
    y = SSM.mlstm_train(h, p, cfg)
    dt_ = h.dtype
    up = torch.matmul(h, p["wup"].to(dt_))
    xi, _ = torch.chunk(up, 2, dim=-1)
    k, v = L._proj(xi, p["wk"]), L._proj(xi, p["wv"])
    log_i, log_f = SSM._mlstm_gates(xi, p, cfg.n_heads)
    kin = SSM._mlstm_key(k, log_i)
    q0 = torch.zeros_like(kin)
    _, Hm = SSM.chunked_lrnn(log_f, kin, q0, v.float(), cache[0])
    ones = torch.ones(v.shape[:-1] + (1,), dtype=torch.float32, device=h.device)
    _, n = SSM.chunked_lrnn(log_f, kin, q0, ones, cache[1])
    return y, (Hm, n)


def _slstm_prefill(h, p, cfg, cache):
    state, hs = SSM._slstm_rows(SSM.slstm_pre(h, p), tuple(cache), p, cfg)
    return SSM._slstm_out(hs, p, cfg, h.dtype), state


def _run_block_prefill(kind, x, p, cache, cfg, positions, shared, enc_out, kv_chunk=512):
    """Returns x; fills ``cache`` (this layer's views) in place."""
    if kind in RECURRENT_KINDS:
        h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
        if kind == "mamba":
            y, h_fin, conv = SSM._mamba_run(h, p["mamba"], cfg, h0=cache[0],
                                            conv_state=torch.zeros_like(cache[1]), chunk=256)
            new = (h_fin, conv)
        elif kind == "mlstm":
            y, new = _mlstm_prefill(h, p["mlstm"], cfg, cache)
        else:
            y, new = _slstm_prefill(h, p["slstm"], cfg, cache)
        _store(cache, new)
        return x + y
    if kind == "shared_attn":
        p = shared
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "mla":
        out, (a, b) = L.mla_prefill(h, p["attn"], cfg, positions, kv_chunk)
    else:
        out, (a, b) = L.gqa_prefill(h, p["attn"], cfg, positions, kv_chunk)
        Sc = cache[0].shape[1]
        if cfg.sliding_window and kind != "shared_attn" and a.shape[1] > Sc:
            a, b = _ring_window(a, Sc), _ring_window(b, Sc)
    x = x + out
    if kind == "dec":
        ek, ev = _cross_kv(enc_out, p, x.dtype)
        x = _cross_attend(x, p, cfg, ek, ev, kv_chunk)
        _store(cache[2:], (ek, ev))
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + _ffn(kind, h, p, cfg, decode=False)
    _prefill_write(cache[0], a)
    _prefill_write(cache[1], b)
    return x


def _run_block_decode(kind, x, p, cache, cfg, pos, shared):
    """x: (B, d). Returns x; writes ``cache`` (this layer's views) in place."""
    if kind in RECURRENT_KINDS:
        h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
        run = {"mamba": SSM.mamba_decode, "mlstm": SSM.mlstm_decode,
               "slstm": SSM.slstm_decode}[kind]
        y, new = run(h, p[kind], cfg, tuple(cache))
        _store(cache, new)
        return x + y
    if kind == "shared_attn":
        p = shared
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "mla":
        out, _ = L.mla_decode(h, p["attn"], cfg, cache, pos)
    else:
        out, _ = L.gqa_decode(h, p["attn"], cfg, cache[:2], pos)
    x = x + out
    if kind == "dec":
        ekc, evc = cache[2], cache[3]
        h = L.rmsnorm(x, p["lnx"], cfg.norm_eps)
        q = L._proj(h, p["xattn"]["wq"].to(x.dtype))
        xout = L.decode_attention(q, ekc, evc, ekc.shape[1])
        x = x + L.gqa_out(xout, p["xattn"])
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(kind, h, p, cfg, decode=True)


def _layer(tree, r: int):
    return tree_map(lambda a: a[r], tree)


def _unstack(tree, n: int) -> List[Any]:
    """The ``n`` per-layer trees of a stacked param tree, each leaf unbound
    along its leading layers axis (views). Under autograd the layers' grads
    come back through one stack a leaf, where indexing layer by layer would
    add a full-size zero-padded grad a layer."""
    flat = {path: leaf.unbind(0) for path, leaf in tree_flatten(tree)}
    return [tree_map_with_path(lambda path, _: flat[path][r], tree) for r in range(n)]


_aten = torch.ops.aten


def _save_plain_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy (``jax.checkpoint_policies.
    checkpoint_dots_with_no_batch_dims``): keep the outputs of products
    without batch dimensions (``torch.matmul`` of activations by a weight is
    an ``mm``; an ``einsum`` without batch dimensions a ``bmm`` of batch 1),
    recompute everything else."""
    plain = op in (_aten.mm.default, _aten.addmm.default) or (
        op is _aten.bmm.default and args[0].shape[0] == 1)
    return CheckpointPolicy.MUST_SAVE if plain else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under activation checkpointing by ``cfg.remat``, as the
    reference wraps each trunk unit and the encoder's layer body in
    ``jax.checkpoint``: ``"none"`` keeps every activation, ``"dots"`` keeps
    the plain products' outputs and recomputes the rest in the backward
    pass, any other value (``"full"``) keeps only the unit's inputs. Only
    when autograd records (a forward without grad saves nothing to
    recompute). Remat changes memory, never values."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_plain_products)
    return lambda *args: checkpoint(fn, *args, **kw)


def _run_block(mode, kind, x, p, cache, cfg, positions, pos, shared, enc_out, kv_chunk):
    if mode == "train":
        return _run_block_train(kind, x, p, cfg, positions, shared, enc_out, kv_chunk)
    if mode == "prefill":
        return _run_block_prefill(kind, x, p, cache, cfg, positions, shared, enc_out,
                                  kv_chunk)
    return _run_block_decode(kind, x, p, cache, cfg, pos, shared)


def _run_trunk(x, params, cfg: ModelConfig, mode: str, positions=None, cache=None,
               pos=None, enc_out=None, kv_chunk: int = 512):
    """Run the trunk's ``layout_repeat`` units in order (in ``"train"``
    mode each unit under :func:`_remat`), then the tail blocks, outside
    remat as in the reference; caches are written in place. Returns x."""
    shared = params.get("shared")

    def unit(x, bp, r):
        bc = _layer(cache["trunk"], r) if cache is not None else None
        for i, kind in enumerate(cfg.layout_unit):
            key = f"{i}_{kind}"
            x = _run_block(mode, kind, x, bp.get(key, {}), bc[key] if bc else None, cfg,
                           positions, pos, shared, enc_out, kv_chunk)
        return x

    if mode == "train":
        unit = _remat(unit, cfg)
    for r, bp in enumerate(_unstack(params["trunk"], cfg.layout_repeat)):
        x = unit(x, bp, r)
    for i, kind in enumerate(cfg.layout_tail):
        key = f"{i}_{kind}"
        x = _run_block(mode, kind, x, params["tail"][key],
                       cache["tail"][key] if cache is not None else None, cfg,
                       positions, pos, shared, enc_out, kv_chunk)
    return x


def _run_encoder(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, enc_seq, d) stub frontend embeddings -> the encoder
    output: bidirectional self-attention with RoPE (the reference's default
    chunk of 512), then the encoder's final norm; each layer's body under
    :func:`_remat`."""
    enc = params["encoder"]
    positions = torch.arange(frames.shape[1], device=frames.device)

    def body(x, bp):
        h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = L.gqa_qkv(h, bp["attn"], cfg, positions)
        attn = L.flash_attention(q, k, v, causal=False, cross=True)
        x = x + L.gqa_out(attn, bp["attn"])
        h = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        return x + L.mlp(h, bp["mlp"], cfg.act)

    body = _remat(body, cfg)
    x = frames
    for bp in _unstack(enc["trunk"], cfg.n_enc_layers):
        x = body(x, bp["0_enc"])
    return L.rmsnorm(x, enc["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Public forwards
# ---------------------------------------------------------------------------


def _prefix_embeds(x_tok, embeds, params):
    if embeds is None:
        return x_tok
    dt = x_tok.dtype
    proj = torch.matmul(embeds.to(dt), params["frontend_proj"]["w"].to(dt))
    return torch.cat([proj, x_tok], dim=1)


def _inputs(params, cfg: ModelConfig, tokens, embeds, frames):
    """The trunk's input (embedded tokens after any projected prefix), its
    positions and the encoder output (None without frames)."""
    dt = as_dtype(cfg.dtype)
    x0 = _prefix_embeds(L.embed(tokens, params["embed"], dt), embeds, params)
    positions = torch.arange(x0.shape[1], device=x0.device)
    enc_out = _run_encoder(params, cfg, frames.to(dt)) if frames is not None else None
    return x0, positions, enc_out


def _logits(x, params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return L.unembed(x, params["embed"])
    logits = torch.matmul(x, params["head"]["w"].to(x.dtype))
    return shard_activation(logits, ("batch", "seq", "vocab")) if x.dim() == 3 else logits


def _increment(x, x0):
    return x.float() - x0.float()


def forward_train(params, cfg: ModelConfig, tokens: torch.Tensor,
                  embeds=None, frames=None, kv_chunk: int = 512,
                  increment: bool = False):
    """tokens: (B, S) -> logits (B, P + S, vocab) [, trunk increment
    (B, P + S, d)], P the ``embeds`` prefix's length (0 without)."""
    x0, positions, enc_out = _inputs(params, cfg, tokens, embeds, frames)
    x = _run_trunk(x0, params, cfg, "train", positions, enc_out=enc_out, kv_chunk=kv_chunk)
    logits = _logits(L.rmsnorm(x, params["final_norm"], cfg.norm_eps), params, cfg)
    return (logits, _increment(x, x0)) if increment else logits


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
            embeds=None, frames=None, kv_chunk: int = 512,
            increment: bool = False):
    """Full-context forward filling ``cache`` in place. Returns
    ``(last_logits (B, vocab), cache[, trunk increment (B, P + S, d)])``."""
    x0, positions, enc_out = _inputs(params, cfg, tokens, embeds, frames)
    x = _run_trunk(x0, params, cfg, "prefill", positions, cache=cache, enc_out=enc_out,
                   kv_chunk=kv_chunk)
    logits = _logits(L.rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps), params, cfg)
    return (logits, cache, _increment(x, x0)) if increment else (logits, cache)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos, cache,
                increment: bool = False):
    """token: (B,) ints; pos: () or (B,) current positions; ``cache`` is
    written in place. Returns ``(logits (B, vocab), cache[, trunk increment
    (B, d)])``."""
    x0 = L.embed(token, params["embed"], as_dtype(cfg.dtype))  # (B, d)
    x0 = shard_activation(x0, ("batch", "embed"))
    x = _run_trunk(x0, params, cfg, "decode", cache=cache, pos=pos)
    logits = _logits(L.rmsnorm(x, params["final_norm"], cfg.norm_eps), params, cfg)
    logits = shard_activation(logits, ("batch", "vocab"))
    return (logits, cache, _increment(x, x0)) if increment else (logits, cache)
