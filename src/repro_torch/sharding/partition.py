"""Mesh partitioning rules: logical axes -> partition specs, as
``repro.sharding.partition`` declares them.

Two rule sets (installed separately: activation names overlap param names
like "embed" but mean different tensors):

* PARAM rules: tensor parallelism on the "model" axis (mlp/heads/vocab) and
  FSDP (ZeRO-3-style) sharding of the remaining embed axis over ("pod",
  "data"). DTensor's sharding propagation then gathers a weight where a
  product needs it whole on "data", and reduce-scatters its grad: the FSDP
  schedule.
* ACTIVATION rules: batch over ("pod", "data"); TP-parallel inner dims over
  "model"; decode-time KV caches sequence-sharded ("kv_seq"). Long-context
  (batch 1) runs spread kv_seq over ("data", "model") instead.

Every assignment is divisibility-checked per tensor (:func:`spec_for`): a
mesh axis that does not evenly divide the dimension (llama's 24 query heads
on a 16-way model axis, minicpm3's 73,448-entry vocab) falls back to the
next candidate and ultimately to replication.

A spec is the port's own: a tuple with one entry per dimension, each
``None``, a mesh-axis name or a tuple of names, equal element for element
to the reference's ``PartitionSpec``. A mesh is anything with a ``shape``
mapping of axis name to size (``launch.mesh.Mesh2D``, or a stub of a
production mesh's shape such as ``{"pod": 2, "data": 16, "model": 16}``),
or that mapping itself: the rules need no processes.
:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh`` whose dims are named by mesh axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models.params import tree_flatten, tree_map_with_path

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True)
class RunProfile:
    """Per-run partitioning choices."""

    long_context: bool = False  # shard kv_seq over (data, model)
    fsdp: bool = True  # shard params' embed axis over (pod, data)
    pipeline: bool = False  # reserved: pod axis used by pipeline stages
    # sequence-parallel / ZeRO-3-everything alternative to the 2D FSDPxTP
    # baseline: activations sharded over "model" on the sequence axis,
    # weights fully sharded over every mesh axis on their embed dim, no
    # tensor-parallel contractions
    seq_parallel: bool = False


def tuned_config(cfg, mesh, prof: Optional[RunProfile] = None):
    """The reference's per-mesh config hints (its dry run's ``_tuned``):
    MoE routing groups tile the token shards, one group a data shard (a
    data shard times a model shard under ``seq_parallel``)."""
    shape = mesh_shape(mesh)
    gb = int(shape.get("pod", 1) * shape["data"])
    gs = int(shape["model"]) if (prof is not None and prof.seq_parallel) else 1
    return dataclasses.replace(cfg, moe_groups=gb * gs, moe_group_shape=(gb, gs))


def mesh_shape(mesh) -> Dict[str, int]:
    """A mesh's axis sizes by name: a mapping as it is, else its ``shape``
    (a ``DeviceMesh``'s dim names zipped with its sizes)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def param_rules(mesh, prof: RunProfile) -> Dict[str, MeshAxes]:
    shape = mesh_shape(mesh)
    dp: MeshAxes = tuple(a for a in ("pod", "data") if a in shape)
    if prof.seq_parallel:
        every = dp + ("model",)
        return {"embed": every, "embed_out": None, "vocab": None, "mlp": None,
                "heads": None, "kv_heads": None, "head_dim": None, "latent": None,
                "expert": None, "layers": None}
    fsdp = dp if prof.fsdp else None
    # long-context serving (global batch 1): the data axis would idle, so
    # tensor-parallel weight axes spread over (data, model)
    tp: MeshAxes = ("data", "model") if prof.long_context else "model"
    return {"embed": fsdp, "embed_out": None, "vocab": tp, "mlp": tp, "heads": tp,
            "kv_heads": tp, "head_dim": None, "latent": None, "expert": None,
            "layers": None}


def act_rules(mesh, prof: RunProfile) -> Dict[str, MeshAxes]:
    shape = mesh_shape(mesh)
    dp: MeshAxes = tuple(a for a in ("pod", "data") if a in shape)
    kv_seq: MeshAxes = ("data", "model") if prof.long_context else "model"
    if prof.seq_parallel:
        return {"batch": dp, "seq": "model", "embed": None, "mlp": None,
                "heads": None, "kv_heads": None, "vocab": None, "kv_seq": kv_seq,
                "exp_group": dp + ("model",), "layers": None}
    tp: MeshAxes = ("data", "model") if prof.long_context else "model"
    return {"batch": dp, "seq": None, "embed": None, "mlp": tp, "heads": tp,
            "kv_heads": tp, "vocab": tp, "kv_seq": kv_seq, "exp_group": dp,
            "layers": None}


def _axes_size(shape: Mapping[str, int], assign: MeshAxes) -> int:
    if assign is None:
        return 1
    group = (assign,) if isinstance(assign, str) else assign
    size = 1
    for a in group:
        size *= shape.get(a, 1)  # an absent axis (smaller mesh) is 1
    return size


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
             rules: Dict[str, MeshAxes]) -> Spec:
    """Divisibility- and conflict-checked spec for one tensor: each
    dimension takes its rule's full mesh-axis group, else a prefix of it,
    else one of its axes, the first that divides it and uses no axis an
    earlier dimension took; else it is replicated."""
    mshape = mesh_shape(mesh)
    used: set = set()
    parts = []
    for dim, name in zip(shape, axes):
        assign = rules.get(name) if name else None
        chosen: MeshAxes = None
        if assign is not None:
            group = (assign,) if isinstance(assign, str) else tuple(assign)
            group = tuple(a for a in group if a in mshape)  # smaller meshes
            candidates = [group] + [group[:i] for i in range(len(group) - 1, 0, -1)]
            candidates += [(a,) for a in group]
            for cand in candidates:
                if any(a in used for a in cand):
                    continue
                size = _axes_size(mshape, cand)
                if dim % size == 0 and size > 1:
                    # a tuple-valued rule stays a tuple with one axis left
                    chosen = (cand if len(cand) > 1 or not isinstance(assign, str)
                              else cand[0])
                    used.update(cand)
                    break
        parts.append(chosen)
    return tuple(parts)


def _is_abstract(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as the reference's ``NamedSharding``."""

    mesh: Any
    spec: Spec

    def placements(self) -> Tuple[Any, ...]:
        return placements(self.spec, device_mesh(self.mesh))

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One rank's block of a tensor of ``shape``, each sharded dimension
        ceil-divided by its group's size (the reference's padded shards)."""
        mshape = mesh_shape(self.mesh)
        out = list(shape)
        for d, part in enumerate(self.spec):
            n = _axes_size(mshape, part)
            out[d] = -(-out[d] // n)
        return tuple(out)


def device_mesh(mesh):
    """The ``DeviceMesh`` of ``mesh``: itself, or a ``Mesh2D``'s view."""
    return mesh if hasattr(mesh, "mesh_dim_names") else mesh.device_mesh


def shardings_for_tree(abstract_tree: Any, axes_tree: Any, mesh,
                       rules: Dict[str, MeshAxes]) -> Any:
    """Abstract (or real) tensor tree + logical-axes tree -> tree of
    :class:`NamedSharding`."""
    axes = dict(tree_flatten(axes_tree, _is_axes))
    return tree_map_with_path(
        lambda path, t: NamedSharding(mesh, spec_for(tuple(t.shape), axes[path],
                                                     mesh, rules)),
        abstract_tree, _is_abstract)


def batch_sharding(mesh, prof: RunProfile, ndim: int,  # noqa: ARG001
                   batch_divisible: bool) -> NamedSharding:
    dp = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return NamedSharding(mesh, ((dp if batch_divisible else None),) + (None,) * (ndim - 1))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def keystr(path: Tuple) -> str:
    """A tree path as ``jax.tree_util.keystr`` writes it."""
    return "".join(f"[{k!r}]" for k in path)


def report_fallbacks(abstract_tree: Any, axes_tree: Any, mesh,
                     rules: Dict[str, MeshAxes]) -> Dict[str, Tuple]:
    """Which tensors could not take their preferred sharding."""
    axes = dict(tree_flatten(axes_tree, _is_axes))
    out = {}
    for path, t in tree_flatten(abstract_tree, _is_abstract):
        spec = spec_for(tuple(t.shape), axes[path], mesh, rules)
        want = tuple(rules.get(a) if a else None for a in axes[path])
        if any(w is not None and g is None for w, g in zip(want, spec)):
            out[keystr(path)] = (tuple(t.shape), axes[path], spec)
    return out


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: Spec, device_mesh) -> Tuple[Any, ...]:
    """A spec as DTensor placements on ``device_mesh`` (dims named by mesh
    axes): ``Shard(d)`` on each mesh dim that dimension ``d``'s group names,
    ``Replicate()`` on the others. A group of two axes on one dimension
    shards it major to minor in the group's order, which is the mesh's
    row-major order. A spec naming an axis the mesh lacks raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        if part is None:
            continue
        group = (part,) if isinstance(part, str) else part
        for a in group:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh has {names}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_slices(shape: Sequence[int], dmesh, places) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under ``places`` on
    ``dmesh``: each sharded dimension cut evenly by its mesh dims, the
    earlier mesh dim major (DTensor's order)."""
    coord = dmesh.get_coordinate()
    out = []
    for d, n in enumerate(shape):
        lo, size = 0, n
        for m, pl in enumerate(places):
            if pl.is_shard(d):
                size //= dmesh.size(m)
                lo += coord[m] * size
        out.append(slice(lo, lo + size))
    return tuple(out)


def shard_tensor(t, sharding: NamedSharding, device=None):
    """A DTensor of ``t`` (the whole tensor, the same on every rank) placed
    by ``sharding``: each rank keeps its own block, a copy (on ``device``
    when given, else ``t``'s), and nothing is communicated. Every spec of
    the rules divides its dimensions evenly."""
    from torch.distributed.tensor import DTensor

    dm = device_mesh(sharding.mesh)
    places = sharding.placements()
    block = t[local_slices(t.shape, dm, places)]
    block = block.to(device, copy=True) if device is not None else block.clone()
    return DTensor.from_local(block, dm, places, run_check=False)


def shard_tree(tree, shardings, device=None):
    """:func:`shard_tensor` at every leaf of ``tree``."""
    by_path = dict(tree_flatten(shardings, lambda x: isinstance(x, NamedSharding)))
    return tree_map_with_path(lambda path, t: shard_tensor(t, by_path[path], device), tree)


def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


class _ContiguousGrad(torch.autograd.Function):
    """Identity; the grad passed back contiguous. A DTensor's strides are
    its global shape's, so a DTensor grad built from a permuted local block
    (an einsum's backward) fails a later view."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(t):
    """``t``, its grad made contiguous in the backward (see
    :class:`_ContiguousGrad`): for a local block taken out of a DTensor."""
    return _ContiguousGrad.apply(t)


def gather_tensor(t):
    """A DTensor whole on every rank (a collective; differentiable), a
    plain tensor as it is."""
    return contiguous_grad(t.full_tensor()) if is_sharded(t) else t


def pad_blocks(x, pad: Tuple[int, ...]):
    """``F.pad(x, pad)`` (zeros). On a DTensor each rank pads its own block:
    the padded dims made whole and partial sums reduced first, the result
    placed as the block was, so no pad op sees a DTensor: DTensor's
    redistribution fails on ``F.pad`` in torch 2.11 (ROADMAP Queue 3 item
    14)."""
    import torch.nn.functional as F

    if not is_sharded(x):
        return F.pad(x, pad)
    from torch.distributed.tensor import DTensor, Replicate

    dims = {x.dim() - 1 - i // 2 for i, n in enumerate(pad) if n}
    want = [Replicate() if pl.is_partial() or any(pl.is_shard(d) for d in dims) else pl
            for pl in x.placements]
    if want != list(x.placements):
        x = x.redistribute(x.device_mesh, want)
    block = F.pad(contiguous_grad(x.to_local()), pad)
    return DTensor.from_local(block, x.device_mesh, want, run_check=False)


def local(t):
    """A DTensor's block on this rank (its storage: an in-place op on it
    updates the DTensor), a plain tensor as it is."""
    return t.to_local() if is_sharded(t) else t
