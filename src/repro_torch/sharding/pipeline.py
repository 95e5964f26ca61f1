"""Pipeline parallelism over a stage group (GPipe-style microbatching), as
``repro.sharding.pipeline``.

Each rank of ``group`` is one stage and holds its own slice of the stacked
per-layer params: stage ``s`` of ``P`` holds layers ``[s R/P, (s+1) R/P)``.
Every stage runs the same loop over ``n_micro + P - 1`` ticks: at each tick
it applies its layers to the activation it holds and passes the result to
the next stage (a ring permute: stage ``s`` sends to ``s + 1`` and receives
from ``s - 1``, by P2P ``isend``/``irecv``; by an all-gather where the
group is gloo and the tensors CUDA). Microbatch ``m`` enters stage 0
at tick ``m`` and leaves stage ``P - 1`` at tick ``m + P - 1``. A stage
skips its layers at the ticks where it holds no microbatch (the reference
masks that compute; it reaches no output either way) and sends zeros.

The permute is an ``autograd.Function`` whose backward is the reverse
permute, so ``torch.autograd`` of a pipelined forward is the pipelined
backward. Only the last stage holds the outputs; an all-reduce over the
group makes them whole on every stage, and its backward passes each
stage's grad through unchanged (the output is replicated: every stage
computes the same loss from it). Each stage's backward must run every
tick's reverse permute, in the same order as the other stages, for the
sends to meet their receives: a bubble tick sends a zero tensor that
requires grad, so its permute is in the graph too, and the output is tied
to every tick's received tensor (with a zero grad) so that the backward
from it reaches them all, from the last tick down.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_flatten, tree_map_with_path


def _ring(group):
    P = dist.get_world_size(group)
    s = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (s + 1) % P)
    prev = dist.get_global_rank(group, (s - 1) % P)
    return nxt, prev


def _permute(t: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send ``t`` to ``dst`` and return what ``src`` sent (same shape). Gloo
    takes no CUDA tensor in ``send``/``recv`` (checked on an H100, torch
    2.11): there every stage's tensor is all-gathered and the sender's
    kept, which moves P times the bytes and nothing through the host."""
    t = t.contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        return parts[dist.get_group_rank(group, src)]
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, dst, group), dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingPermute(torch.autograd.Function):
    """Forward: to the next stage; backward: the grad to the previous."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        nxt, prev = _ring(group)
        return _permute(t, nxt, prev, group)

    @staticmethod
    def backward(ctx, g):
        nxt, prev = _ring(ctx.group)
        return _permute(g, prev, nxt, ctx.group), None


class _SumToAll(torch.autograd.Function):
    """Forward: the sum over the group on every stage; backward: identity."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Tie(torch.autograd.Function):
    """``out`` unchanged; in the backward a zero grad for each tensor tied
    to it (so the backward reaches them)."""

    @staticmethod
    def forward(ctx, out, *tied):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in tied]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.shapes])


def pipeline_apply(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   local_stacked_params: Any, x: torch.Tensor, group, n_micro: int
                   ) -> torch.Tensor:
    """Run ``layer_fn(params_r, h)`` for r = 0..R-1 as a P-stage pipeline
    over ``group`` (a process group; ``None`` is the world).

    local_stacked_params: this stage's layers, a tree whose leaves have a
        leading axis of R/P layers.
    x: (B, ...) the global batch, the same on every stage; B % n_micro == 0.
    Returns the sequential composition of all R layers applied to ``x``, on
    every stage."""
    group = group if group is not None else dist.group.WORLD
    P = dist.get_world_size(group)
    stage = dist.get_rank(group)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
    mb = B // n_micro
    xm = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    flat = {path: leaf.unbind(0) for path, leaf in tree_flatten(local_stacked_params)}
    n_local = len(next(iter(flat.values())))
    layers = [tree_map_with_path(lambda path, _: flat[path][r], local_stacked_params)
              for r in range(n_local)]

    def apply_local(h):
        for pr in layers:
            h = layer_fn(pr, h)
        return h

    grad = torch.is_grad_enabled()
    buf = torch.zeros_like(xm[0])
    outs = [torch.zeros_like(xm[0]) for _ in range(n_micro)]
    received = []
    for t in range(n_micro + P - 1):
        m_here = t - stage               # the microbatch this stage holds
        if 0 <= m_here < n_micro:
            h = apply_local(xm[m_here] if stage == 0 else buf)
        else:                            # a bubble: no microbatch here
            h = torch.zeros_like(xm[0]).requires_grad_(grad)
        if stage == P - 1 and m_here >= 0:
            outs[m_here] = h
        if P > 1:
            buf = _RingPermute.apply(h, group)
            received.append(buf)
    out = torch.stack(outs)
    if P > 1:
        out = _SumToAll.apply(out, group)
        if grad:
            out = _Tie.apply(out, *received)
    return out.reshape((B,) + tuple(out.shape[2:]))
