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
    train   — full-sequence causal forward, logits for CE loss
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

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import (
    ParamSpec, is_spec, leaf_keys, stack_specs, tree_flatten, tree_init, tree_map,
    tree_map_with_path,
)

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
    unstacked. Recurrent states are float32, other leaves ``dtype``."""
    dev = resolve_device(device)
    dt = as_dtype(dtype)
    R = cfg.layout_repeat
    cache = {"trunk": {f"{i}_{k}": _block_cache(k, cfg, B, S, dt, dev, (R,))
                       for i, k in enumerate(cfg.layout_unit)}}
    if cfg.layout_tail:
        cache["tail"] = {f"{i}_{k}": _block_cache(k, cfg, B, S, dt, dev)
                         for i, k in enumerate(cfg.layout_tail)}
    return cache


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
    """Write a full prefix into the start of a cache buffer, in place."""
    c[:, :new.shape[1]] = new.to(c.dtype)


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
    state, hs = SSM._slstm_scan(SSM.slstm_pre(h, p), tuple(cache), p, cfg)
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
            # keep the last `window` positions (ring-buffer layout: slot = pos % Sc)
            S = a.shape[1]
            a = torch.roll(a[:, S - Sc:], shifts=S % Sc, dims=1)
            b = torch.roll(b[:, S - Sc:], shifts=S % Sc, dims=1)
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


def _run_block(mode, kind, x, p, cache, cfg, positions, pos, shared, enc_out, kv_chunk):
    if mode == "train":
        return _run_block_train(kind, x, p, cfg, positions, shared, enc_out, kv_chunk)
    if mode == "prefill":
        return _run_block_prefill(kind, x, p, cache, cfg, positions, shared, enc_out,
                                  kv_chunk)
    return _run_block_decode(kind, x, p, cache, cfg, pos, shared)


def _run_trunk(x, params, cfg: ModelConfig, mode: str, positions=None, cache=None,
               pos=None, enc_out=None, kv_chunk: int = 512):
    """Run the trunk's ``layout_repeat`` units in order, then the tail
    blocks; caches are written in place. Returns x."""
    shared = params.get("shared")
    for r in range(cfg.layout_repeat):
        bp = _layer(params["trunk"], r)
        bc = _layer(cache["trunk"], r) if cache is not None else None
        for i, kind in enumerate(cfg.layout_unit):
            key = f"{i}_{kind}"
            x = _run_block(mode, kind, x, bp.get(key, {}), bc[key] if bc else None, cfg,
                           positions, pos, shared, enc_out, kv_chunk)
    for i, kind in enumerate(cfg.layout_tail):
        key = f"{i}_{kind}"
        x = _run_block(mode, kind, x, params["tail"][key],
                       cache["tail"][key] if cache is not None else None, cfg,
                       positions, pos, shared, enc_out, kv_chunk)
    return x


def _run_encoder(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, enc_seq, d) stub frontend embeddings -> the encoder
    output: bidirectional self-attention with RoPE (the reference's default
    chunk of 512), then the encoder's final norm."""
    enc = params["encoder"]
    positions = torch.arange(frames.shape[1], device=frames.device)
    x = frames
    for r in range(cfg.n_enc_layers):
        bp = _layer(enc["trunk"], r)["0_enc"]
        h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = L.gqa_qkv(h, bp["attn"], cfg, positions)
        attn = L.flash_attention(q, k, v, causal=False, cross=True)
        x = x + L.gqa_out(attn, bp["attn"])
        h = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        x = x + L.mlp(h, bp["mlp"], cfg.act)
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
    return torch.matmul(x, params["head"]["w"].to(x.dtype))


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
    x = _run_trunk(x0, params, cfg, "decode", cache=cache, pos=pos)
    logits = _logits(L.rmsnorm(x, params["final_norm"], cfg.norm_eps), params, cfg)
    return (logits, cache, _increment(x, x0)) if increment else (logits, cache)
