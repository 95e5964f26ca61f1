"""Mixture-of-Experts FFN (Mixtral / Grok-1: 8 experts, top-2 routing), as
``repro.models.moe`` computes it.

GShard-style local groups: tokens are split into routing groups and each
group routes independently with a local capacity
``int((tokens_per_group * top_k / E) * capacity_factor) + 1``. Dispatch is
scatter-based (positions by a masked cumsum); tokens over capacity fall
through with a zero expert contribution (the residual carries them): they
are scattered to and gathered from ``(expert 0, slot cap - 1)`` with their
contribution and gate set to 0.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec
from repro_torch.sharding.context import shard_activation
from repro_torch.sharding.partition import is_sharded


def moe_spec(cfg) -> Dict[str, ParamSpec]:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, E), ("embed", None)),
        "wi": ParamSpec((E, d, f), ("expert", "embed", "mlp")),
        "wg": ParamSpec((E, d, f), ("expert", "embed", "mlp")),
        "wo": ParamSpec((E, f, d), ("expert", "mlp", "embed")),
    }


def top_k(logits: torch.Tensor, k: int):
    """The ``k`` largest values along the last axis and their indices, the
    lower index first among equal values (``lax.top_k``'s order; a stable
    descending sort keeps it, ``torch.topk`` does not promise it)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _groups(cfg, B: int, S: int, n_groups: int):
    """(gb, gs): routing groups over the batch and the sequence."""
    if n_groups:
        gb, gs = n_groups, 1
    else:
        gb, gs = getattr(cfg, "moe_group_shape", ()) or (cfg.moe_groups or 1, 1)
    while B % gb:
        gb //= 2
    while S % gs:
        gs //= 2
    return gb, gs


def _dispatch(x, router, cfg, gb: int, gs: int, cap: int):
    """Route ``x`` (B, S, d) in ``gb * gs`` groups: the (G, E, cap, d)
    expert buffers and what :func:`_combine` needs."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    dt = x.dtype
    dev = x.device
    G = gb * gs
    g_tokens = B * S // G
    xg = (x.reshape(gb, B // gb, gs, S // gs, d)
          .permute(0, 2, 1, 3, 4)
          .reshape(G, g_tokens, d))
    logits = torch.matmul(xg, router.to(dt)).float()
    gate, idx = top_k(logits, k)  # (G, T, k)
    gate = torch.softmax(gate, dim=-1).to(dt)

    # position of each (token, choice) within its expert's capacity buffer
    onehot = F.one_hot(idx, E)  # (G, T, k, E)
    flat = onehot.reshape(G, g_tokens * k, E)
    pos = torch.cumsum(flat, dim=1) - 1  # (G, T*k, E)
    pos = (pos * flat).sum(-1).reshape(G, g_tokens, k)  # (G, T, k)
    keep = pos < cap
    gate = gate * keep.to(dt)

    e_idx = torch.where(keep, idx, 0)
    c_idx = torch.where(keep, pos, cap - 1)
    contrib = torch.where(keep[..., None], xg[:, :, None, :], 0).to(dt)  # (G, T, k, d)
    g_idx = torch.arange(G, device=dev)[:, None, None].expand(G, g_tokens, k)
    buf = torch.zeros((G, E, cap, d), dtype=dt, device=dev)
    buf.index_put_((g_idx, e_idx, c_idx), contrib, accumulate=True)
    return buf, (g_idx, e_idx, c_idx, gate, (B, S, d, gb, gs))


def _combine(y, route):
    g_idx, e_idx, c_idx, gate, (B, S, d, gb, gs) = route
    out = y[g_idx, e_idx, c_idx] * gate[..., None]  # (G, T, k, d)
    return (out.sum(dim=2)
            .reshape(gb, gs, B // gb, S // gs, d)
            .permute(0, 2, 1, 3, 4)
            .reshape(B, S, d))


def _experts(buf, p, dt):
    """The expert FFN (tensor-parallel on d_ff) over the dispatch buffers."""
    buf = shard_activation(buf, ("exp_group", None, None, "embed"))
    h = torch.einsum("gecd,edf->gecf", buf, p["wi"].to(dt))
    g_ = torch.einsum("gecd,edf->gecf", buf, p["wg"].to(dt))
    h = F.silu(g_) * h
    h = shard_activation(h, ("exp_group", None, None, "mlp"))
    y = torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))
    return shard_activation(y, ("exp_group", None, None, "embed"))


def moe_ffn(x: torch.Tensor, p: Dict, cfg, n_groups: int = 0) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). top-k routing with local groups tiling the
    (batch, seq) grid as ``moe_group_shape = (batch_shards, seq_shards)``
    (else ``(moe_groups or 1, 1)``); ``n_groups`` overrides it (decode: 1)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    gb, gs = _groups(cfg, B, S, n_groups)
    cap = int((B * S // (gb * gs) * k / E) * cfg.moe_capacity_factor) + 1
    if is_sharded(x):
        return _moe_sharded(x, p, cfg, gb, gs, cap)
    buf, route = _dispatch(x, p["router"], cfg, gb, gs, cap)
    return shard_activation(_combine(_experts(buf, p, x.dtype), route),
                            ("batch", "seq", "embed"))


class _AllReduceGrad(torch.autograd.Function):
    """Identity; in the backward the grad, a partial sum over the mesh dims
    ``dims`` (placements otherwise ``places``), summed over them."""

    @staticmethod
    def forward(ctx, t, dm, places, dims):
        ctx.dm, ctx.places, ctx.dims = dm, list(places), list(dims)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if not ctx.dims:
            return g, None, None, None
        from torch.distributed.tensor import DTensor, Partial

        partial = [Partial() if i in ctx.dims else pl for i, pl in enumerate(ctx.places)]
        g = DTensor.from_local(g.contiguous(), ctx.dm, partial, run_check=False)
        return g.redistribute(ctx.dm, ctx.places).to_local(), None, None, None


def _moe_sharded(x, p, cfg, gb: int, gs: int, cap: int):
    """:func:`moe_ffn` of a DTensor ``x``, on each rank's blocks. DTensor has
    no rule for the routing's sort, cumsum and capacity scatter, and its
    backward through the experts' einsums fails a view of a permuted block
    (torch 2.11), so each rank routes the tokens it holds and runs the
    experts on them as plain tensors, which is the reference's placement:
    where the groups tile the data shards (``moe_groups`` a multiple of the
    data axes' size, as the launcher's ``tuned_config`` sets it) the rank's
    rows are whole groups ("exp_group" over the data axes) and the routing
    is the reference's, group for group; otherwise ``x`` is made whole and
    every rank routes it all. The router and the expert weights are
    gathered over the data axes (FSDP), the expert weights kept sharded on
    d_ff ("mlp") over the model axis, whose partial outputs are summed over
    it; the weights' grads are partial sums over the data shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = x.device_mesh
    dp_dims = [i for i, pl in enumerate(x.placements) if pl.is_shard(0)]
    n_dp = math.prod(dm.size(i) for i in dp_dims)
    if not (n_dp > 1 and gb % n_dp == 0):
        dp_dims, n_dp = [], 1
    want = tuple(Shard(0) if i in dp_dims else Replicate() for i in range(dm.ndim))

    def gathered(w, f_dim: int):
        keep = [Shard(f_dim) if pl.is_shard(f_dim) and i not in dp_dims else Replicate()
                for i, pl in enumerate(w.placements)]
        grad = [Partial() if i in dp_dims else keep[i] for i in range(dm.ndim)]
        return w.redistribute(dm, keep).to_local(grad_placements=grad), keep

    dt = x.dtype
    xl = x.redistribute(dm, want).to_local()
    router, _ = gathered(p["router"], -1)
    buf, route = _dispatch(xl, router, cfg, gb // n_dp, gs, cap)
    (wi, keep), (wg, _), (wo, _) = (gathered(p["wi"], 2), gathered(p["wg"], 2),
                                    gathered(p["wo"], 1))
    # d_ff sharded over the model dims: buf's grad is a partial sum there
    buf = _AllReduceGrad.apply(buf, dm, want, [i for i, pl in enumerate(keep) if pl.is_shard()])
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, wg.to(dt))) * torch.einsum(
        "gecd,edf->gecf", buf, wi.to(dt))
    y = torch.einsum("gecf,efd->gecd", h, wo.to(dt))
    # y is a partial sum over the mesh dims that shard d_ff
    partial = [Partial() if pl.is_shard() else w for pl, w in zip(keep, want)]
    y = DTensor.from_local(y, dm, partial, run_check=False).redistribute(dm, want).to_local()
    out = _combine(y, route)
    return shard_activation(DTensor.from_local(out, dm, want, run_check=False),
                            ("batch", "seq", "embed"))
