"""The collectives DTensor issues, on gloo with CUDA tensors, through the
``torch.distributed`` calls that take them.

When the ranks of a mesh share one card, the transport is gloo over CUDA
tensors (NCCL refuses two ranks on one card). Called directly through
``torch.distributed``, gloo takes CUDA tensors in ``all_reduce``,
``all_gather``, ``broadcast``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_to_all_single``; but DTensor's
redistributions issue them as functional collectives
(``torch.ops._c10d_functional``), whose gloo path crashes a rank on CUDA
tensors (SIGSEGV), and its ``send``/``recv`` fail (``writev ... Bad
address``): checked on an H100 with torch 2.11. :func:`install` registers,
for the CUDA dispatch key of the functional all-gather, reduce-scatter and
all-reduce and of DTensor's ``shard_dim_alltoall``, implementations by the
direct calls: an all-gather into a list and a concatenation; an all-reduce
and the rank's chunk for a reduce-scatter; an all-gather and the rank's
chunk for an all-to-all, as DTensor's own fallback for CPU groups does.
Nothing moves through the host in the port's code. It is installed only by
a process whose mesh runs gloo on the card (``launch.mesh.Mesh2D.
device_mesh``); the values are the native collectives' (the same sums in
the same group order: a CPU run with it installed for the CPU key gives
the same bits).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_LIB = None


def _group(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name)


def _all_gather_into_tensor(inp, group_size: int, group_name: str):
    pg = _group(group_name)
    parts = [torch.empty_like(inp) for _ in range(group_size)]
    dist.all_gather(parts, inp.contiguous(), group=pg)
    return torch.cat(parts, dim=0)


def _reduce_op(name: str):
    return {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.AVG, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}[name.lower()]


def _all_reduce(inp, reduce_op: str, group_name: str):
    out = inp.clone(memory_format=torch.contiguous_format)
    op = reduce_op.lower()
    dist.all_reduce(out, op=_reduce_op("sum" if op == "avg" else op), group=_group(group_name))
    if op == "avg":
        out.div_(dist.get_world_size(_group(group_name)))
    return out


def _reduce_scatter_tensor(inp, reduce_op: str, group_size: int, group_name: str):
    whole = _all_reduce(inp, reduce_op, group_name)
    rank = dist.get_rank(_group(group_name))
    return whole.chunk(group_size, dim=0)[rank].contiguous()


def _shard_dim_alltoall(inp, gather_dim: int, shard_dim: int, group_name: str):
    """DTensor's Shard(gather_dim) -> Shard(shard_dim): the whole tensor
    gathered along ``gather_dim`` and this rank's chunk of ``shard_dim``,
    DTensor's own fallback for CPU groups."""
    pg = _group(group_name)
    n, rank = dist.get_world_size(pg), dist.get_rank(pg)
    parts = [torch.empty_like(inp) for _ in range(n)]
    dist.all_gather(parts, inp.contiguous(), group=pg)
    whole = torch.cat(parts, dim=gather_dim)
    return whole.chunk(n, dim=shard_dim)[rank].contiguous()


def installed() -> bool:
    """Whether :func:`install` has run in this process (a mesh over NCCL
    must never need it)."""
    return _LIB is not None


def install(key: str = "CUDA") -> None:
    """Register the implementations above for the ``key`` dispatch key
    (once a process; ``"CPU"`` only to check them against gloo's own)."""
    global _LIB
    if _LIB is not None:
        return
    import warnings

    libs = (torch.library.Library("_c10d_functional", "IMPL"),
            torch.library.Library("_dtensor", "IMPL"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # "overriding a previously registered kernel"
        libs[0].impl("all_gather_into_tensor", _all_gather_into_tensor, key)
        libs[0].impl("reduce_scatter_tensor", _reduce_scatter_tensor, key)
        libs[0].impl("all_reduce", _all_reduce, key)
        libs[1].impl("shard_dim_alltoall", _shard_dim_alltoall, key)
    _LIB = libs
