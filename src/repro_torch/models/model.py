"""Model builder: ParamSpec trees + train/prefill/decode forwards for the
attention-decoder families of the registry (dense GQA, MLA, MoE + SWA, and
the VLM's text trunk), as ``repro.models.model`` builds and runs them.

The tree layout is the reference's, name for name: ``embed``, ``trunk``
(one repeating unit of block kinds, its leaves stacked on a leading layers
axis), ``final_norm``, ``head`` (unless tied), ``frontend_proj`` (stub
modality projector). Where the reference scans the stacked layers, the port
loops over them in Python. Caches keep the reference's stacked layout too
(``{"trunk": {"0_dense": (k, v)}}``, each leaf (layers, B, S, ...)), and
the forwards write them in place.

Modes:
    train   — full-sequence causal forward, logits for CE loss
    prefill — full-sequence forward that also fills the KV caches
    decode  — one token against pre-allocated caches (serve_step)

Each forward can also return the trunk increment: the residual stream after
the trunk, before ``final_norm``, minus the embedded input, in float32 (at
the reference's random weights the logits barely see the trunk, so parity
checks compare this too).

The block kinds of the encoder-decoder (``enc``, ``dec``), SSM (``mlstm``,
``slstm``) and hybrid (``mamba``, ``shared_attn``) families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.params import (
    ParamSpec, leaf_keys, stack_specs, tree_init, tree_map, tree_map_with_path,
)

ATTENTION_KINDS = ("dense", "moe", "mla")
DEFERRED = {
    "enc": "ROADMAP Queue 1 item 6(a) (encdec: the encoder and cross-attention cache)",
    "dec": "ROADMAP Queue 1 item 6(a) (encdec: the encoder and cross-attention cache)",
    "mamba": "ROADMAP Queue 1 item 6(b) (ssm and hybrid: models/ssm.py)",
    "mlstm": "ROADMAP Queue 1 item 6(b) (ssm and hybrid: models/ssm.py)",
    "slstm": "ROADMAP Queue 1 item 6(b) (ssm and hybrid: models/ssm.py)",
    "shared_attn": "ROADMAP Queue 1 item 6(b) (ssm and hybrid: zamba2's shared attention)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config with a block kind the port
    does not run yet, naming its ROADMAP item."""
    for kind in dict.fromkeys(cfg.layer_kinds):
        if kind in DEFERRED:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet: {DEFERRED[kind]}")
        if kind not in ATTENTION_KINDS:
            raise ValueError(f"unknown block kind {kind}")


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


def _block_spec(kind: str, cfg: ModelConfig) -> Dict[str, Any]:
    if kind == "dense":
        return {
            "ln1": L.rmsnorm_spec(cfg.d_model),
            "attn": L.gqa_spec(cfg),
            "ln2": L.rmsnorm_spec(cfg.d_model),
            "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act),
        }
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
    raise ValueError(f"unknown block kind {kind}")


def build_specs(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    unit = {f"{i}_{k}": _block_spec(k, cfg) for i, k in enumerate(cfg.layout_unit)}
    specs: Dict[str, Any] = {
        "embed": L.embed_spec(cfg.vocab_size, cfg.d_model),
        "trunk": stack_specs(unit, cfg.layout_repeat),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["head"] = {
            "w": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
        }
    if cfg.frontend:
        # stub modality projector (frontend embeddings are precomputed inputs)
        specs["frontend_proj"] = {
            "w": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed_out"))
        }
    return specs


def init_params(cfg: ModelConfig, key, device="cuda"):
    """The reference's ``init_params(cfg, key)``, bit for bit, drawn on
    ``device`` (float32 leaves)."""
    return tree_init(build_specs(cfg), key, device)


def param_keys(cfg: ModelConfig, key) -> Dict[tuple, torch.Tensor]:
    """Each parameter's path -> the key its leaf is drawn from."""
    return leaf_keys(build_specs(cfg), key)


# leaves the reference reads in float32 whatever the compute dtype (norm
# scales: ``rmsnorm`` casts them to float32)
F32_LEAVES = ("scale", "q_norm", "kv_norm")


def compute_params(params, dtype) -> Any:
    """One compute copy of a param tree: every leaf in ``dtype`` except the
    norm scales, which stay as they are. The forwards then compute what the
    reference computes by casting each weight at its use; a leaf already in
    ``dtype`` is shared, not copied."""
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


def _block_cache(kind: str, cfg: ModelConfig, B: int, S: int, dtype, device):
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    R = cfg.layout_repeat
    if kind in ("dense", "moe"):
        Sc = min(S, cfg.sliding_window) if cfg.sliding_window else S
        shape = (R, B, Sc, KV, hd)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
    if kind == "mla":
        return (torch.zeros((R, B, S, cfg.kv_lora_rank), dtype=dtype, device=device),
                torch.zeros((R, B, S, cfg.qk_rope_dim), dtype=dtype, device=device))
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, B: int, S: int, dtype=torch.bfloat16, device="cuda"):
    """Zero caches for ``B`` rows of ``S`` positions, stacked over the
    trunk's layers (sliding-window layers hold a ring of ``window``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    return {
        "trunk": {
            f"{i}_{k}": _block_cache(k, cfg, B, S, as_dtype(dtype), dev)
            for i, k in enumerate(cfg.layout_unit)
        }
    }


# ---------------------------------------------------------------------------
# Block forwards
# ---------------------------------------------------------------------------


def _ffn(kind, h, p, cfg, decode: bool):
    if kind == "moe":
        if decode:
            return MOE.moe_ffn(h[:, None, :], p["moe"], cfg, n_groups=1)[:, 0]
        return MOE.moe_ffn(h, p["moe"], cfg)
    return L.mlp(h, p["mlp"], cfg.act)


def _run_block_train(kind, x, p, cfg, positions, kv_chunk=512):
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "mla":
        x = x + L.mla_attend_train(h, p["attn"], cfg, positions, kv_chunk)
    else:
        x = x + L.gqa_attend_train(h, p["attn"], cfg, positions, kv_chunk)
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(kind, h, p, cfg, decode=False)


def _prefill_write(c: torch.Tensor, new: torch.Tensor) -> None:
    """Write a full prefix into the start of a cache buffer, in place."""
    c[:, :new.shape[1]] = new.to(c.dtype)


def _run_block_prefill(kind, x, p, cache, cfg, positions, kv_chunk=512):
    """Returns x; fills ``cache`` (this layer's views) in place."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "mla":
        out, (a, b) = L.mla_prefill(h, p["attn"], cfg, positions, kv_chunk)
    else:
        out, (a, b) = L.gqa_prefill(h, p["attn"], cfg, positions, kv_chunk)
        Sc = cache[0].shape[1]
        if cfg.sliding_window and a.shape[1] > Sc:
            # keep the last `window` positions (ring-buffer layout: slot = pos % Sc)
            S = a.shape[1]
            a = torch.roll(a[:, S - Sc:], shifts=S % Sc, dims=1)
            b = torch.roll(b[:, S - Sc:], shifts=S % Sc, dims=1)
    x = x + out
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + _ffn(kind, h, p, cfg, decode=False)
    _prefill_write(cache[0], a)
    _prefill_write(cache[1], b)
    return x


def _run_block_decode(kind, x, p, cache, cfg, pos):
    """x: (B, d). Returns x; writes ``cache`` (this layer's views) in place."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "mla":
        out, _ = L.mla_decode(h, p["attn"], cfg, cache, pos)
    else:
        out, _ = L.gqa_decode(h, p["attn"], cfg, cache, pos)
    x = x + out
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(kind, h, p, cfg, decode=True)


def _layer(tree, r: int):
    return tree_map(lambda a: a[r], tree)


def _run_trunk(x, params, cfg: ModelConfig, mode: str, positions=None, cache=None,
               pos=None, kv_chunk: int = 512):
    """Run the trunk's ``layout_repeat`` units in order; caches are written
    in place. Returns x."""
    for r in range(cfg.layout_repeat):
        bp = _layer(params["trunk"], r)
        bc = _layer(cache["trunk"], r) if cache is not None else None
        for i, kind in enumerate(cfg.layout_unit):
            key = f"{i}_{kind}"
            if mode == "train":
                x = _run_block_train(kind, x, bp[key], cfg, positions, kv_chunk)
            elif mode == "prefill":
                x = _run_block_prefill(kind, x, bp[key], bc[key], cfg, positions, kv_chunk)
            else:
                x = _run_block_decode(kind, x, bp[key], bc[key], cfg, pos)
    return x


# ---------------------------------------------------------------------------
# Public forwards
# ---------------------------------------------------------------------------


def _no_prefix(embeds, frames) -> None:
    if embeds is not None:
        raise NotImplementedError(
            "the VLM embeds prefix is not ported yet: ROADMAP Queue 1 item 6(c)")
    if frames is not None:
        raise NotImplementedError(
            "encoder frames are not ported yet: ROADMAP Queue 1 item 6(a)")


def _logits(x, params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return L.unembed(x, params["embed"])
    return torch.matmul(x, params["head"]["w"].to(x.dtype))


def _increment(x, x0):
    return x.float() - x0.float()


def forward_train(params, cfg: ModelConfig, tokens: torch.Tensor,
                  embeds=None, frames=None, kv_chunk: int = 512,
                  increment: bool = False):
    """tokens: (B, S) -> logits (B, S, vocab) [, trunk increment (B, S, d)]."""
    check_supported(cfg)
    _no_prefix(embeds, frames)
    x0 = L.embed(tokens, params["embed"], as_dtype(cfg.dtype))
    positions = torch.arange(x0.shape[1], device=x0.device)
    x = _run_trunk(x0, params, cfg, "train", positions, kv_chunk=kv_chunk)
    logits = _logits(L.rmsnorm(x, params["final_norm"], cfg.norm_eps), params, cfg)
    return (logits, _increment(x, x0)) if increment else logits


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
            embeds=None, frames=None, kv_chunk: int = 512,
            increment: bool = False):
    """Full-context forward filling ``cache`` in place. Returns
    ``(last_logits (B, vocab), cache[, trunk increment (B, S, d)])``."""
    check_supported(cfg)
    _no_prefix(embeds, frames)
    x0 = L.embed(tokens, params["embed"], as_dtype(cfg.dtype))
    positions = torch.arange(x0.shape[1], device=x0.device)
    x = _run_trunk(x0, params, cfg, "prefill", positions, cache=cache, kv_chunk=kv_chunk)
    logits = _logits(L.rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps), params, cfg)
    return (logits, cache, _increment(x, x0)) if increment else (logits, cache)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos, cache,
                increment: bool = False):
    """token: (B,) ints; pos: () or (B,) current positions; ``cache`` is
    written in place. Returns ``(logits (B, vocab), cache[, trunk increment
    (B, d)])``."""
    check_supported(cfg)
    x0 = L.embed(token, params["embed"], as_dtype(cfg.dtype))  # (B, d)
    x = _run_trunk(x0, params, cfg, "decode", cache=cache, pos=pos)
    logits = _logits(L.rmsnorm(x, params["final_norm"], cfg.norm_eps), params, cfg)
    return (logits, cache, _increment(x, x0)) if increment else (logits, cache)
