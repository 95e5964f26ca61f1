"""Transformer primitives: norms, RoPE, attention (GQA / MLA / SWA, train +
prefill + decode forms), MLPs, embeddings, as ``repro.models.layers``
defines them: pure functions over the param dicts of
``models.params`` trees.

Attention is the reference's plain chunked online softmax
(:func:`flash_attention`, the same chunk order, masks and ``NEG_INF``), so a
long prefill never materializes an (S x S) score tensor; decode attends to
the whole KV cache under a length mask. Products are ``torch.einsum`` in
the activations' dtype (the reference's ``einsum`` outside any kernel);
softmax statistics are float32. A weight is cast to the activations' dtype
at its use, as the reference's ``.astype(dt)``: a no-op on a compute copy
already in that dtype (``model.compute_params``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec
from repro_torch.sharding.context import replicate, shard_activation
from repro_torch.sharding.partition import (
    contiguous_grad, is_sharded, local, local_slices, pad_blocks,
)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms / activations / embeddings
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(x: torch.Tensor, p: Dict, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def embed_spec(vocab: int, d: int) -> Dict[str, ParamSpec]:
    return {"embedding": ParamSpec((vocab, d), ("vocab", "embed"), scale=1.0)}


def embed(tokens: torch.Tensor, p: Dict, dtype: torch.dtype) -> torch.Tensor:
    """Rows of the embedding, in ``dtype`` (gathered, then cast: the same
    values as the reference's cast-then-take). On a mesh the table is made
    whole first: DTensor's rule for a lookup in a vocab-sharded table
    leaves a masked partial sum whose reduction fails on a 2-D mesh."""
    out = F.embedding(tokens, replicate(p["embedding"])).to(dtype)
    return shard_activation(out, ("batch", "seq", "embed"))


def unembed(x: torch.Tensor, p: Dict) -> torch.Tensor:
    logits = torch.einsum("...d,vd->...v", x, p["embedding"].to(x.dtype))
    return shard_activation(logits, ("batch", "seq", "vocab")) if x.dim() == 3 else logits


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    e = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_spec(d: int, f: int, act: str) -> Dict[str, ParamSpec]:
    if act == "swiglu":
        return {
            "wi": ParamSpec((d, f), ("embed", "mlp")),
            "wg": ParamSpec((d, f), ("embed", "mlp")),
            "wo": ParamSpec((f, d), ("mlp", "embed")),
        }
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp(x: torch.Tensor, p: Dict, act: str) -> torch.Tensor:
    dt = x.dtype
    h = torch.matmul(x, p["wi"].to(dt))
    if act == "swiglu":
        g = torch.matmul(x, p["wg"].to(dt))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default form
    # rank-aware: decode-path activations are (B, f), train/prefill (B, S, f)
    h = shard_activation(h, ("batch", "mlp") if h.dim() == 2 else ("batch", "seq", "mlp"))
    return torch.matmul(h, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# Flash attention (chunked online softmax) — train/prefill path
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_chunk: int = 512,
    cross: bool = False,
) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0.

    Chunked online softmax over KV; O(Sq * kv_chunk) live scores. ``window``
    > 0 applies sliding-window masking (Mixtral SWA). ``cross=True`` disables
    causal masking (encoder-decoder cross attention). DTensors run on each
    rank's blocks (:func:`on_blocks`).
    """
    if is_sharded(q):
        return on_blocks(lambda ql, kl, vl, _: flash_attention(
            ql, kl, vl, causal=causal, window=window, q_offset=q_offset,
            kv_chunk=kv_chunk, cross=cross), q, k, v, q_heads=2)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    nchunks = max((Skv + kv_chunk - 1) // kv_chunk, 1)
    pad = nchunks * kv_chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))

    dev = q.device
    qf = (q.float() / (hd ** 0.5)).reshape(B, Sq, KV, rep, hd)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    acc = torch.zeros((B, Sq, KV, rep, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, KV, rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, rep), dtype=torch.float32, device=dev)
    for j in range(nchunks):
        kj = k[:, j * kv_chunk:(j + 1) * kv_chunk].float()
        vj = v[:, j * kv_chunk:(j + 1) * kv_chunk].float()
        s = torch.einsum("bsgrh,bcgh->bsgrc", qf, kj)
        k_pos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = (k_pos < Skv)[None, :]  # mask KV padding
        if not cross:
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bsgrc,bcgh->bsgrh", p, vj)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def on_blocks(fn, q, k, v, q_heads: int):
    """``fn(q, k, v, rows)`` (an attention whose rows and KV-head groups are
    independent; ``rows`` the slice of the batch this rank holds) on each
    rank's blocks of the DTensors: rows sharded as
    ``q``'s batch is, the heads over the mesh dims that shard ``q``'s head
    dim ``q_heads`` where every group size divides the KV heads (the
    matching KV groups with them, ``k``/``v``'s dim 2), every other dim
    whole; the output is a DTensor placed as ``q``. DTensor's propagation
    through the attention's einsums would merge a sharded batch dim with a
    sharded head dim, which torch 2.11 refuses and torch 2.13 does by
    gathering the scores."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm, KV = q.device_mesh, k.shape[2]
    heads = [i for i, pl in enumerate(q.placements) if pl.is_shard(q_heads)]
    if KV % math.prod(dm.size(i) for i in heads):
        heads = []
    want_q, want_kv = [], []
    for i, pl in enumerate(q.placements):
        if pl.is_shard(0):
            want_q.append(Shard(0))
            want_kv.append(Shard(0))
        elif i in heads:
            want_q.append(Shard(q_heads))
            want_kv.append(Shard(2))
        else:
            want_q.append(Replicate())
            want_kv.append(Replicate())
    ql = contiguous_grad(q.redistribute(dm, want_q).to_local())
    kl, vl = (contiguous_grad(t.redistribute(dm, want_kv).to_local()) for t in (k, v))
    rows = local_slices(q.shape, dm, want_q)[0]
    # contiguous: a DTensor's strides are its global shape's, and a later
    # view of a permuted local block fails
    return DTensor.from_local(fn(ql, kl, vl, rows).contiguous(), dm, want_q,
                              run_check=False)


def pos_vec(pos, B: int, device) -> torch.Tensor:
    """Scalar or (B,) position -> (B,) int64 on ``device``."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    return pos.expand(B) if pos.dim() == 0 else pos


def cache_write(cache: torch.Tensor, new: torch.Tensor, slot) -> torch.Tensor:
    """Write one token's K/V at position ``slot`` of a (B, S, ...) cache,
    IN PLACE, and return the cache. ``slot`` may be scalar or per-row (B,)
    (continuous batching); a row whose slot lies outside [0, S) is left as
    it was (the reference's masked select writes nothing there)."""
    B, S = cache.shape[0], cache.shape[1]
    slot = pos_vec(slot, B, cache.device)
    if is_sharded(cache):
        return _sharded_cache_write(cache, new, slot)
    rows = torch.arange(B, device=cache.device)
    inside = (slot >= 0) & (slot < S)
    at = torch.clamp(slot, 0, S - 1)
    keep = cache[rows, at]
    mask = inside.reshape((B,) + (1,) * (keep.dim() - 1))
    cache[rows, at] = torch.where(mask, new.to(cache.dtype), keep)
    return cache


def rows_block(t, cache):
    """For a write of the DTensor ``t`` into a DTensor ``cache``
    (``cache_axes``: rows sharded over the data axes, positions over the
    model axis, the rest whole): ``t``'s rows that this rank's block of the
    cache holds, every other dim whole, as a local tensor; and the cache
    block's slices."""
    from torch.distributed.tensor import Replicate, Shard

    want = [Shard(0) if p.is_shard(0) else Replicate() for p in cache.placements]
    return (local(t.redistribute(t.device_mesh, want)),
            local_slices(cache.shape, cache.device_mesh, cache.placements))


def _sharded_cache_write(cache, new, slot: torch.Tensor):
    """:func:`cache_write` into a DTensor cache: each rank writes the rows
    it holds at the slots that fall in its block of positions."""
    new_l, sl = rows_block(new, cache)
    rows_sl, pos_sl = sl[0], sl[1]
    c = local(cache)
    at = slot[rows_sl] - pos_sl.start
    Bl, Sl = c.shape[0], c.shape[1]
    inside = (at >= 0) & (at < Sl)
    at_c = torch.clamp(at, 0, Sl - 1)
    rows = torch.arange(Bl, device=c.device)
    keep = c[rows, at_c]
    mask = inside.reshape((Bl,) + (1,) * (keep.dim() - 1))
    c[rows, at_c] = torch.where(mask, new_l.to(c.dtype), keep)
    return cache


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, length
) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, H, hd); caches: (B, S, KV, hd); length: () or (B,) valid length.
    DTensors run on each rank's blocks (:func:`on_blocks`), the cache's
    positions made whole.
    """
    if is_sharded(q):
        length = torch.as_tensor(length, device=q.device)
        return on_blocks(lambda ql, kl, vl, rows: decode_attention(
            ql, kl, vl, length[rows] if length.dim() else length),
            q, k_cache, v_cache, q_heads=1)
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    qf = (q.float() / (hd ** 0.5)).reshape(B, KV, rep, hd)
    s = torch.einsum("bgrh,bsgh->bgrs", qf, k_cache.float())
    length = torch.as_tensor(length, device=q.device)
    valid = torch.arange(S, device=q.device)[None, :] < length.reshape(-1, 1)  # (B or 1, S)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgh->bgrh", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (shared by dense / moe)
# ---------------------------------------------------------------------------


def gqa_spec(cfg) -> Dict[str, ParamSpec]:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), init="zeros")
        spec["bk"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
    return spec


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,dhk->...hk")``: x (..., d) by a (d, H, k) weight."""
    d, H, k = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, H * k)).reshape(*x.shape[:-1], H, k)


def _qkv(x: torch.Tensor, p: Dict):
    dt = x.dtype
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    return q, k, v


def gqa_qkv(x: torch.Tensor, p: Dict, cfg, positions: torch.Tensor):
    q, k, v = _qkv(x, p)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_activation(q, ("batch", "seq", "heads", None))
    k = shard_activation(k, ("batch", "seq", "kv_heads", None))
    return q, k, v


def gqa_out(attn: torch.Tensor, p: Dict) -> torch.Tensor:
    """``einsum("...hk,hkd->...d")``."""
    H, k, d = p["wo"].shape
    return torch.matmul(attn.reshape(*attn.shape[:-2], H * k),
                        p["wo"].to(attn.dtype).reshape(H * k, d))


def gqa_attend_train(x, p, cfg, positions, kv_chunk: int = 512):
    q, k, v = gqa_qkv(x, p, cfg, positions)
    attn = flash_attention(
        q, k, v, causal=True, window=cfg.sliding_window, kv_chunk=kv_chunk
    )
    return gqa_out(attn, p)


def gqa_prefill(x, p, cfg, positions, kv_chunk: int = 512):
    """Returns (out, (k, v)) — the full prefill K/V for the cache."""
    q, k, v = gqa_qkv(x, p, cfg, positions)
    attn = flash_attention(
        q, k, v, causal=True, window=cfg.sliding_window, kv_chunk=kv_chunk
    )
    return gqa_out(attn, p), (k, v)


def gqa_decode(x, p, cfg, cache: Tuple[torch.Tensor, torch.Tensor], pos):
    """x: (B, d) one new token. cache: k/v (B, S, KV, hd), written in place;
    pos: () shared or (B,) per-row position (continuous batching).

    With sliding-window configured the cache is a ring buffer of size
    ``window`` and positions index modulo it.
    """
    k_cache, v_cache = cache
    B = x.shape[0]
    S = k_cache.shape[1]
    q, k, v = _qkv(x, p)
    pos_b = pos_vec(pos, B, x.device)
    q = apply_rope(q[:, None], pos_b[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos_b[:, None], cfg.rope_theta)[:, 0]
    slot = pos_b % S if cfg.sliding_window > 0 else pos_b
    cache_write(k_cache, k, slot)
    cache_write(v_cache, v, slot)
    length = torch.clamp_max(pos_b + 1, S)
    out = decode_attention(q, k_cache, v_cache, length)
    return gqa_out(out, p), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek-style)
# ---------------------------------------------------------------------------


def mla_spec(cfg) -> Dict[str, ParamSpec]:
    d, H = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, ropd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wdq": ParamSpec((d, rq), ("embed", "latent")),
        "q_norm": ParamSpec((rq,), ("latent",), init="ones"),
        "wuq": ParamSpec((rq, H, nope + ropd), ("latent", "heads", "head_dim")),
        "wdkv": ParamSpec((d, rkv), ("embed", "latent")),
        "kv_norm": ParamSpec((rkv,), ("latent",), init="ones"),
        "wkr": ParamSpec((d, ropd), ("embed", None)),
        "wuk": ParamSpec((rkv, H, nope), ("latent", "heads", "head_dim")),
        "wuv": ParamSpec((rkv, H, vd), ("latent", "heads", "head_dim")),
        "wo": ParamSpec((H, vd, d), ("heads", "head_dim", "embed")),
    }


def _mla_q(x, p, cfg, positions):
    dt = x.dtype
    nope = cfg.qk_nope_dim
    cq = torch.matmul(x, p["wdq"].to(dt))
    cq = rmsnorm(cq, {"scale": p["q_norm"]}, cfg.norm_eps)
    q = _proj(cq, p["wuq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_ckv(x, p, cfg, positions):
    dt = x.dtype
    c = torch.matmul(x, p["wdkv"].to(dt))
    c = rmsnorm(c, {"scale": p["kv_norm"]}, cfg.norm_eps)
    kr = torch.matmul(x, p["wkr"].to(dt))
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c, kr  # (B,S,rkv), (B,S,ropd)


def mla_attend_train(x, p, cfg, positions, kv_chunk: int = 512):
    out, _ = mla_prefill(x, p, cfg, positions, kv_chunk)
    return out


def mla_prefill(x, p, cfg, positions, kv_chunk: int = 512):
    q_nope, q_rope = _mla_q(x, p, cfg, positions)
    c, kr = _mla_ckv(x, p, cfg, positions)
    # reconstruct full per-head K/V for the flash pass
    k_nope = _proj(c, p["wuk"])
    v = _proj(c, p["wuv"])
    H = cfg.n_heads
    k_rope = kr[:, :, None, :].expand(*kr.shape[:2], H, kr.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    # pad V's head_dim up to qk dim so flash can run one fused pass
    vd, qk = cfg.v_head_dim, cfg.qk_nope_dim + cfg.qk_rope_dim
    v_p = pad_blocks(v, (0, qk - vd)) if qk > vd else v
    attn = flash_attention(q, k, v_p, causal=True, kv_chunk=kv_chunk)[..., :vd]
    return gqa_out(attn, p), (c, kr)


def mla_decode(x, p, cfg, cache, pos):
    """Absorbed-matrix MLA decode: attention runs in the rkv-dim latent space;
    the cache stores only (c_kv, k_rope), written in place.
    x: (B, d); cache: (c (B,S,rkv), kr (B,S,ropd)).
    """
    dt = x.dtype
    c_cache, kr_cache = cache
    B = x.shape[0]
    S = c_cache.shape[1]
    pos_b = pos_vec(pos, B, x.device)
    q_nope, q_rope = _mla_q(x[:, None], p, cfg, pos_b[:, None])
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]  # (B,H,nope),(B,H,ropd)
    c_new, kr_new = _mla_ckv(x[:, None], p, cfg, pos_b[:, None])
    cache_write(c_cache, c_new[:, 0], pos_b)
    cache_write(kr_cache, kr_new[:, 0], pos_b)
    # absorb W_uk into q: q_lat (B,H,rkv)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope, p["wuk"].to(dt))
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), c_cache.float())
    s = s + torch.einsum("bhk,bsk->bhs", q_rope.float(), kr_cache.float())
    s = s / ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)
    valid = torch.arange(S, device=x.device)[None, None, :] <= pos_b[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", pr, c_cache.float()).to(dt)
    o = torch.einsum("bhr,rhk->bhk", o_lat, p["wuv"].to(dt))  # absorb W_uv
    return gqa_out(o, p), (c_cache, kr_cache)
